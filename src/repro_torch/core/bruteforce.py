"""Tiny pairwise-join oracle for tests (Selinger-style, dict-merged).

Reference: ``repro/core/bruteforce.py`` (this module is a copy of it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .cq import CQ
from .db import Database


def brute_force_evaluate(q: CQ, db: Database) -> Set[Tuple[int, ...]]:
    """All satisfying assignments, as tuples over ``q.variables``."""
    assignments: List[Dict[str, int]] = [dict()]
    for atom in q.atoms:
        rel = db.relations[atom.relation]
        nxt: List[Dict[str, int]] = []
        for mu in assignments:
            for row in rel:
                ok = True
                ext = dict(mu)
                for x, val in zip(atom.vars, row):
                    val = int(val)
                    if x in ext:
                        if ext[x] != val:
                            ok = False
                            break
                    else:
                        ext[x] = val
                if ok:
                    nxt.append(ext)
        assignments = nxt
        if not assignments:
            return set()
    allv = q.variables
    return {tuple(mu[x] for x in allv) for mu in assignments}


def brute_force_count(q: CQ, db: Database) -> int:
    return len(brute_force_evaluate(q, db))
