"""Versioned on-disk snapshots of the serving layer's warm state.

One compressed ``.npz`` holds, per resident plan: the canonical query,
TD and order (enough to rebuild the engine in a fresh process), the
schedule signature it was lowered to, and every tier-2 table's exported
state — key/count planes, payload metadata, the slab arena *and its
host-side epoch* (``slab_bump``/``payload_flushes``; see
:meth:`~repro_torch.core.cache.DeviceCache.import_state` for why the epoch
matters).  The manifest layout is the reference's (version 1); the port
has no kernel autotune, so the snapshot carries tables only.

Failure discipline: a missing, truncated, corrupt or wrong-version
snapshot, or one written under another engine config, is a *cold start*,
never an error — per plan (one bad plan record cannot spoil the rest)
and per table (the cache's import validation cold-starts just the
payload region when the slab epoch is unusable).  Writes are atomic
(temporary file + ``os.replace``), so a concurrent reader never sees a
torn snapshot.

Reference: ``repro/serve/persist.py``.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict

import numpy as np

from ..core.cq import CQ, Atom
from ..core.td import TreeDecomposition

__all__ = ["SNAPSHOT_VERSION", "save_snapshot", "load_snapshot"]

SNAPSHOT_VERSION = 1
_SCALARS = ("slab_bump", "payload_flushes", "tick")
_COLD = {"status": "cold", "plans": 0, "tables": 0, "flushed": 0,
         "skipped": 0}


def save_snapshot(path: str, plan_cache) -> str:
    """Write the plan cache's warm state to ``path``; returns ``path``."""
    manifest: Dict = {"version": SNAPSHOT_VERSION,
                      "cfg_key": plan_cache.cfg_key, "plans": []}
    arrays: Dict[str, np.ndarray] = {}
    for i, entry in enumerate(plan_cache.entries()):
        rec = {"atoms": [[a.relation, list(a.vars)] for a in entry.cq.atoms],
               "bags": [sorted(b) for b in entry.td.bags],
               "parent": list(entry.td.parent),
               "order": list(entry.order),
               # the writer's key components ("auto" when its clients let
               # the planner choose): the loader registers under these so
               # a fresh process's td=None lookups hit
               "td_key": entry.key[1],
               "order_key": entry.key[2],
               "schedule_sig": entry.schedule_sig,
               "tables": {}}
        for node, st in entry.engine.cache.export_state().items():
            names, scal = {}, {}
            for k, v in st.items():
                if k in _SCALARS:
                    scal[k] = int(v)
                else:
                    names[k] = nm = f"p{i}_n{node}_{k}"
                    arrays[nm] = np.asarray(v)
            rec["tables"][str(node)] = {"arrays": names, **scal}
        manifest["plans"].append(rec)
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode("utf-8"), np.uint8).copy()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)
    return path


def load_snapshot(path: str, plan_cache) -> Dict[str, object]:
    """Warm ``plan_cache`` from a snapshot written by :func:`save_snapshot`.

    Each persisted plan is rebuilt through ``plan_cache.restore`` (under
    the writer's key, so ``td=None`` client lookups hit) and its tier-2
    tables adopt the persisted state.  A plan whose schedule signature no
    longer matches (the lowering changed since the snapshot) is skipped
    cold.  Returns a summary: ``status`` (``"ok"``, ``"config-mismatch"``
    when the snapshot was written under another engine config, which
    loads nothing, or ``"cold"`` after a warning for an unreadable file)
    and the counts of ``plans`` loaded, tables ``"ok"`` and
    ``"flushed"``, and plans ``skipped``.  Never raises."""
    out = {"status": "ok", "plans": 0, "tables": 0, "flushed": 0,
           "skipped": 0}
    try:
        with np.load(path) as z:
            manifest = json.loads(bytes(z["manifest"]).decode("utf-8"))
            if manifest.get("version") != SNAPSHOT_VERSION:
                raise ValueError(
                    f"snapshot version {manifest.get('version')!r} != "
                    f"{SNAPSHOT_VERSION}")
            if manifest.get("cfg_key") != plan_cache.cfg_key:
                # another engine config keys other plans and other table
                # geometry: start cold
                out["status"] = "config-mismatch"
                return out
            plans = manifest.get("plans", [])
            if not isinstance(plans, list):
                raise TypeError("plans must be a list")
            for rec in plans:
                try:
                    _load_plan(z, rec, plan_cache, out)
                except Exception as e:
                    warnings.warn(
                        f"skipping one snapshot plan from {path}: {e}")
                    out["skipped"] += 1
    except Exception as e:
        warnings.warn(f"ignoring unreadable serve snapshot {path}: {e}")
        return dict(_COLD)
    return out


def _load_plan(z, rec: Dict, plan_cache, out: Dict[str, object]) -> None:
    cq = CQ(tuple(Atom(str(rel), tuple(str(v) for v in vs))
                  for rel, vs in rec["atoms"]))
    td = TreeDecomposition([frozenset(b) for b in rec["bags"]],
                           [int(p) for p in rec["parent"]])
    order = tuple(str(v) for v in rec["order"])
    entry, _resident = plan_cache.restore(
        cq, td, order, td_key=str(rec.get("td_key", "auto")),
        order_key=str(rec.get("order_key", "auto")))
    if entry.schedule_sig != rec.get("schedule_sig"):
        # the table state describes another instruction stream
        out["skipped"] += 1
        return
    states: Dict[int, Dict[str, object]] = {}
    for node, trec in rec["tables"].items():
        st: Dict[str, object] = {k: z[nm] for k, nm in trec["arrays"].items()}
        for k in _SCALARS:
            if k in trec:
                st[k] = int(trec[k])
        states[int(node)] = st
    statuses = entry.engine.cache.import_state(states)
    out["plans"] += 1
    out["tables"] += sum(1 for s in statuses.values() if s == "ok")
    out["flushed"] += sum(1 for s in statuses.values() if s == "flushed")
