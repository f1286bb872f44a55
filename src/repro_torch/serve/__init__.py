"""Query-serving layer over the join-engine facade.

Caching subtree results pays off when joins *recur*, and across queries
only if something outlives one engine object.  This package is that
something:

* :mod:`canonical` — canonical labeling of CQ shapes and TDs, so
  isomorphic queries derive the same plan-cache key (copied from the
  reference);
* :mod:`plancache` — the compile-once plan cache: one long-lived
  :class:`~repro_torch.core.cached_frontier.CachedTrieJoin` per canonical
  ``(CQ shape, TD, order, JoinEngineConfig)``, its tier-2 tables staying
  warm across queries;
* :mod:`persist` — versioned on-disk snapshots of the plan cache's
  tier-2 tables, so warmth survives the *process* (an unusable file is a
  cold start, never an error);
* :mod:`session` — admission and queueing: many concurrent clients ride
  ``evaluate_stream`` through one device-serial worker, with bounded
  in-flight sessions and rejection with a retry-after hint.

Entry point: ``repro_torch.core.engine.serve(db)`` or :class:`JoinServer`.
Reference: ``repro/serve``.
"""
from .canonical import canonical_cq, canonical_td, config_key
from .plancache import CachedPlan, PlanCache
from .persist import SNAPSHOT_VERSION, load_snapshot, save_snapshot
from .session import JoinServer, Session, SessionRejected

__all__ = [
    "canonical_cq", "canonical_td", "config_key",
    "CachedPlan", "PlanCache",
    "SNAPSHOT_VERSION", "load_snapshot", "save_snapshot",
    "JoinServer", "Session", "SessionRejected",
]
