"""YTD — Yannakakis's algorithm over a tree decomposition (paper §5.1).

Per the paper's implementation notes: each bag is materialized with a
worst-case-optimal join (we reuse our LFTJ as the GenericJoin stand-in,
including atoms *touching* the bag and projecting — the EmptyHeaded-style
edge-cover handling); counting aggregates bottom-up per adhesion key instead
of storing full intermediates; evaluation semijoin-reduces then enumerates.

Reference: ``repro/core/yannakakis.py`` (this module is a copy of it).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from .cq import CQ, Atom
from .db import Counters, Database
from .lftj_ref import LFTJ
from .td import TreeDecomposition


class YTD:
    def __init__(self, q: CQ, td: TreeDecomposition, db: Database,
                 counters: Optional[Counters] = None):
        self.q = q
        self.td = td
        self.db = db
        self.counters = counters if counters is not None else Counters()
        # deterministic global variable order for tuple layouts
        self.var_pos = {x: i for i, x in enumerate(q.variables)}

    # -- bag materialization -------------------------------------------------
    def _bag_vars(self, v: int) -> Tuple[str, ...]:
        return tuple(sorted(self.td.bags[v], key=self.var_pos.get))

    def _materialize_bag(self, v: int) -> Tuple[Tuple[str, ...], Set[Tuple[int, ...]]]:
        """R_v = π_{χ(v)}( join of atoms touching χ(v) ), via LFTJ."""
        bag = set(self.td.bags[v])
        atoms = [a for a in self.q.atoms if set(a.vars) & bag]
        assert atoms, f"bag {v} touches no atom"
        sub = CQ(tuple(atoms))
        sub_vars = list(sub.variables)
        # order: bag vars first (so projection is a prefix — cheap dedupe)
        order = sorted(sub_vars, key=lambda x: (x not in bag, self.var_pos[x]))
        bag_vars = tuple(x for x in order if x in bag)
        k = len(bag_vars)
        out: Set[Tuple[int, ...]] = set()
        eng = LFTJ(sub, order, self.db, self.counters)
        for tup in eng.evaluate():
            out.add(tup[:k])
        self.counters.intermediate_tuples += len(out)
        return bag_vars, out

    # -- counting (bottom-up adhesion-keyed aggregation) ----------------------
    def count(self) -> int:
        td = self.td
        bag_rel: Dict[int, Tuple[Tuple[str, ...], Set[Tuple[int, ...]]]] = {
            v: self._materialize_bag(v) for v in range(td.num_nodes)}
        # M[v]: adhesion key -> number of subtree extensions
        M: Dict[int, Dict[Tuple[int, ...], int]] = {}
        for v in reversed(td.preorder()):
            vars_v, rel_v = bag_rel[v]
            pos_v = {x: i for i, x in enumerate(vars_v)}
            child_keys = [
                (c, tuple(pos_v[x] for x in sorted(td.adhesion(c),
                                                   key=self.var_pos.get)))
                for c in td.children[v]]
            adh = tuple(pos_v[x] for x in sorted(td.adhesion(v),
                                                 key=self.var_pos.get))
            acc: Dict[Tuple[int, ...], int] = defaultdict(int)
            for t in rel_v:
                prod = 1
                for c, idx in child_keys:
                    self.counters.count_hash()
                    prod *= M[c].get(tuple(t[i] for i in idx), 0)
                    if prod == 0:
                        break
                if prod:
                    acc[tuple(t[i] for i in adh)] += prod
            M[v] = dict(acc)
        root_total = sum(M[td.root].values())
        return root_total

    # -- evaluation (semijoin reduce + enumerate) -----------------------------
    def evaluate(self) -> List[Tuple[int, ...]]:
        td = self.td
        bag_rel = {v: self._materialize_bag(v) for v in range(td.num_nodes)}

        def project(t, idx):
            return tuple(t[i] for i in idx)

        # bottom-up semijoin: keep parent tuples with a match in every child
        order_nodes = td.preorder()
        for v in reversed(order_nodes):
            vars_v, rel_v = bag_rel[v]
            pos_v = {x: i for i, x in enumerate(vars_v)}
            for c in td.children[v]:
                vars_c, rel_c = bag_rel[c]
                pos_c = {x: i for i, x in enumerate(vars_c)}
                shared = sorted(td.adhesion(c), key=self.var_pos.get)
                idx_v = tuple(pos_v[x] for x in shared)
                idx_c = tuple(pos_c[x] for x in shared)
                keys = {project(t, idx_c) for t in rel_c}
                self.counters.count_hash(len(rel_v))
                rel_v = {t for t in rel_v if project(t, idx_v) in keys}
            bag_rel[v] = (vars_v, rel_v)
        # top-down semijoin
        for v in order_nodes:
            vars_v, rel_v = bag_rel[v]
            pos_v = {x: i for i, x in enumerate(vars_v)}
            for c in td.children[v]:
                vars_c, rel_c = bag_rel[c]
                pos_c = {x: i for i, x in enumerate(vars_c)}
                shared = sorted(td.adhesion(c), key=self.var_pos.get)
                idx_v = tuple(pos_v[x] for x in shared)
                idx_c = tuple(pos_c[x] for x in shared)
                keys = {project(t, idx_v) for t in rel_v}
                self.counters.count_hash(len(rel_c))
                bag_rel[c] = (vars_c,
                              {t for t in rel_c if project(t, idx_c) in keys})
        # index children by adhesion key
        child_index: Dict[int, Dict[Tuple[int, ...], List[Tuple[int, ...]]]] = {}
        for v in order_nodes:
            vars_v, rel_v = bag_rel[v]
            pos_v = {x: i for i, x in enumerate(vars_v)}
            if td.parent[v] >= 0:
                shared = sorted(td.adhesion(v), key=self.var_pos.get)
                idx = tuple(pos_v[x] for x in shared)
                index: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = defaultdict(list)
                for t in rel_v:
                    index[project(t, idx)].append(t)
                child_index[v] = dict(index)

        # enumerate full assignments by walking bags in preorder
        all_vars = self.q.variables
        n = len(all_vars)
        results: List[Tuple[int, ...]] = []
        mu: Dict[str, int] = {}

        def rec(i: int) -> None:
            if i == len(order_nodes):
                results.append(tuple(mu[x] for x in all_vars))
                self.counters.tuples_emitted += 1
                return
            v = order_nodes[i]
            vars_v, rel_v = bag_rel[v]
            if td.parent[v] >= 0:
                shared = sorted(td.adhesion(v), key=self.var_pos.get)
                key = tuple(mu[x] for x in shared)
                self.counters.count_hash()
                cand = child_index[v].get(key, [])
            else:
                cand = list(rel_v)
            for t in cand:
                consistent = True
                added: List[str] = []
                for x, val in zip(vars_v, t):
                    if x in mu:
                        if mu[x] != val:
                            consistent = False
                            break
                    else:
                        mu[x] = val
                        added.append(x)
                if consistent:
                    rec(i + 1)
                for x in added:
                    del mu[x]

        rec(0)
        return results


def ytd_count(q: CQ, td: TreeDecomposition, db: Database,
              counters: Optional[Counters] = None) -> int:
    return YTD(q, td, db, counters).count()


def ytd_evaluate(q: CQ, td: TreeDecomposition, db: Database,
                 counters: Optional[Counters] = None) -> List[Tuple[int, ...]]:
    return YTD(q, td, db, counters).evaluate()
