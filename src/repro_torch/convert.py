"""Carry the reference's state across to the port.

The join has no weights: its state is the database, the query and the
plan.  :func:`from_reference` rebuilds the port's objects from plain
Python and numpy values that the reference's objects expose (relations,
atoms, TD bags and parents, variable order), so both engines can run the
same plan and a difference in planning cannot hide a difference in
execution.  :func:`table_from_reference` carries a warm tier-2 table
across: the state a reference table exports as numpy arrays becomes a
port :class:`~.core.cache.DeviceCache`, so a warm pass can be compared
with the reference's warm pass from the same tables.
:func:`static_tables_from_reference` does the same for the static
executor's tables (tuples of planes), so a warm static pass of the port
can start from the reference's cold-pass tables.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.cache import CacheConfig, DeviceCache
from .core.cq import CQ, Atom
from .core.db import Database
from .core.frontier import resolve_device
from .core.td import TreeDecomposition

# dtypes of a static table tuple's planes, in order: keys, vals, used,
# stamp, cost, then with payloads pay_off, pay_len, slab and bump
_STATIC_DTYPES = (torch.int64, torch.int64, torch.bool, torch.int32,
                  torch.int64, torch.int32, torch.int32, torch.int32,
                  torch.int32)

__all__ = ["from_reference", "table_from_reference",
           "static_tables_from_reference"]


def from_reference(relations: Dict[str, np.ndarray],
                   atoms: Sequence[Tuple[str, Tuple[str, ...]]],
                   bags: Sequence[FrozenSet[str]], parent: Sequence[int],
                   order: Sequence[str],
                   children: Optional[Sequence[Sequence[int]]] = None,
                   ) -> Tuple[Database, CQ, TreeDecomposition,
                              Tuple[str, ...]]:
    """The port's ``(Database, CQ, TreeDecomposition, order)``.

    ``relations`` maps names to ``(N, k)`` integer arrays, ``atoms`` lists
    ``(relation, variables)`` pairs in query order, ``bags``/``parent``
    describe the TD (``parent[root] == -1``) and ``children``, when given,
    keeps the reference's child order (by default children follow node
    index order)."""
    db = Database({name: np.asarray(rows, dtype=np.int64)
                   for name, rows in relations.items()})
    q = CQ(tuple(Atom(rel, tuple(vs)) for rel, vs in atoms))
    kids: List[List[int]] = ([] if children is None
                             else [list(c) for c in children])
    td = TreeDecomposition([frozenset(b) for b in bags],
                           [int(p) for p in parent], kids)
    return db, q, td, tuple(order)


def table_from_reference(state: Dict[str, object], config: CacheConfig,
                         device="cuda") -> DeviceCache:
    """A port tier-2 table holding a reference table's exported state.

    ``state`` is what the reference's ``DeviceCache.export_state()``
    returns: the ``keys``/``vals``/``used``/``stamp``/``cost`` planes, and
    with payloads the ``pay_off``/``pay_len`` planes, the ``slab`` (when
    the arena was allocated), ``slab_bump``, ``payload_flushes`` and the
    LRU ``tick``.  The planes keep the reference's dtypes (int64 keys,
    counts and costs, int32 stamps and payload pointers); the table's
    geometry comes from their shape.  The table lives on ``device`` (the
    card unless the caller asks for the CPU).  Raises ``ValueError`` on
    planes that do not fit ``config``."""
    dev = resolve_device(device)
    dtypes = {"keys": np.int64, "vals": np.int64, "used": bool,
              "stamp": np.int32, "cost": np.int64}
    planes = {k: np.asarray(state[k], dt) for k, dt in dtypes.items()}
    shape = planes["keys"].shape
    if len(shape) != 2 or shape[1] != config.ways or any(
            a.shape != shape for a in planes.values()):
        raise ValueError(f"table planes of shape {shape} do not fit "
                         f"{config.ways} ways")

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)  # a writable copy

    tbl = DeviceCache.create(config, shape[0] * shape[1], device=dev)
    tbl.keys, tbl.vals, tbl.used, tbl.stamp, tbl.cost = (
        t(planes[k]) for k in dtypes)
    tbl.tick = int(state.get("tick", 0))
    if config.cache_payloads:
        tbl.pay_off = t(np.asarray(state["pay_off"], np.int32))
        tbl.pay_len = t(np.asarray(state["pay_len"], np.int32))
        if tbl.pay_off.shape != shape or tbl.pay_len.shape != shape:
            raise ValueError("payload planes do not match the key planes")
        if "slab" in state:
            slab = np.asarray(state["slab"], np.int32)
            if slab.shape[0] != config.payload_rows + 1:
                raise ValueError(f"slab of {slab.shape[0]} rows, config "
                                 f"needs {config.payload_rows + 1}")
            tbl.slab = t(slab)
        tbl.slab_bump = int(state["slab_bump"])
        tbl.payload_flushes = int(state.get("payload_flushes", 0))
    return tbl


def static_tables_from_reference(tables: Dict[int, Sequence[object]],
                                 device="cuda") -> Dict[int, tuple]:
    """The port's static tables from a reference ``StaticCLFTJ`` tables
    dict (node id to a tuple of planes, given as numpy arrays): the
    count-only 5-tuple ``(keys, vals, used, stamp, cost)`` or the 9-tuple
    adding ``(pay_off, pay_len, slab, bump)``, each plane a tensor of the
    reference's dtype on ``device`` (the card unless the caller asks for
    the CPU).  Raises ``ValueError`` on a tuple of another length or
    planes of mismatched shapes."""
    dev = resolve_device(device)
    out: Dict[int, tuple] = {}
    for node, tbl in tables.items():
        if len(tbl) not in (5, 9):
            raise ValueError(f"table {node}: {len(tbl)} planes, expected "
                             f"5 or 9")
        planes = tuple(torch.from_numpy(np.array(a)).to(dev, dt)
                       for a, dt in zip(tbl, _STATIC_DTYPES))
        shape = planes[0].shape
        if any(x.shape != shape for x in planes[1:min(len(planes), 7)]):
            raise ValueError(f"table {node}: planes of unequal shape")
        if len(planes) == 9 and planes[8].dim() != 0:
            raise ValueError(f"table {node}: bump must be a scalar")
        out[int(node)] = planes
    return out
