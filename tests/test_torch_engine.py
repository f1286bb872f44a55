"""The port's facade (``repro_torch.core.engine``, on the CPU) against the
JAX reference's (``repro.core.engine``, ``backend="jax"``) on the same
database and the same plan, carried across by ``repro_torch.convert``:

* equal counts, over every tier-2 policy, capacities 2^8 and 2^12, and
  tier-1 dedup on and off for the 4-cycle and the bowtie, and in one
  configuration each for the other queries of the corpus;
* equal tuples in the same block order from ``evaluate``;
* equal ``tier1_rows_collapsed`` and ``tier2_{hits,misses,probes,inserts,
  evictions,resizes}``;
* the same number of ``device_get`` syncs, label by label.
"""
import itertools

import numpy as np
import pytest

from repro.core import engine as r_engine
from repro.core.cache import CacheConfig as RCacheConfig
from repro.core.cq import (bowtie_query, cycle_query, lollipop_query,
                           path_query, star_query)
from repro.core.db import graph_db
from repro.core.hostsync import SyncCounter as RSyncCounter
from repro_torch.convert import from_reference
from repro_torch.core import engine as t_engine
from repro_torch.core.cache import CacheConfig as TCacheConfig
from repro_torch.core.hostsync import SyncCounter as TSyncCounter

CORPUS = [("path-4", path_query(4)), ("cycle-4", cycle_query(4)),
          ("bowtie", bowtie_query()), ("lollipop-3-2", lollipop_query(3, 2)),
          ("star-3", star_query(3))]
POLICIES = ["direct", "setassoc", "costaware"]
CAPACITIES = [1 << 8, 1 << 12]
DEDUPS = [True, False]
# the full grid runs on these; each other query gets one configuration
# (query, policy, capacity, dedup), so every policy, capacity and dedup
# setting still meets a query outside the grid
GRID = ("cycle-4", "bowtie")
SINGLES = [("path-4", "setassoc", 1 << 8, True),
           ("lollipop-3-2", "costaware", 1 << 12, False),
           ("star-3", "direct", 1 << 8, False)]
QUERIES = dict(CORPUS)


def _case(qname, *rest):
    dedup = rest[-1]
    tag = "-".join([qname, *map(str, rest[:-1]),
                    "dedup" if dedup else "nodedup"])
    return pytest.param(qname, QUERIES[qname], *rest, id=tag)


COUNT_CASES = [_case(qn, p, c, d) for qn, p, c, d in itertools.product(
    GRID, POLICIES, CAPACITIES, DEDUPS)] + [_case(*x) for x in SINGLES]
EVAL_CASES = [_case(qn, c, d) for qn, c, d in itertools.product(
    GRID, CAPACITIES, DEDUPS)] + [_case(qn, c, d) for qn, _, c, d in SINGLES]
STATS = ["tier1_rows_collapsed"] + [
    f"tier2_{k}" for k in ("hits", "misses", "probes", "inserts",
                           "evictions", "resizes")]


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    return graph_db(rng.integers(0, 12, size=(80, 2)))


_PLANS = {}


def _plan(qname, q, db):
    """Reference plan plus the port's copy of db, query and plan."""
    if qname not in _PLANS:
        td, order = r_engine.plan_query(q, db)
        _PLANS[qname] = (td, order) + from_reference(
            db.relations, [(a.relation, a.vars) for a in q.atoms], td.bags,
            td.parent, order, td.children)
    return _PLANS[qname]


def _assert_same_run(r, t, rs, ts):
    for k in STATS:
        assert t.counters.get(k, 0) == r.counters.get(k, 0), k
    assert ts.count == rs.count, (ts.events, rs.events)
    assert ts.label_counts == rs.label_counts


@pytest.mark.parametrize("qname,q,policy,capacity,dedup", COUNT_CASES)
def test_count_matches_reference(db, qname, q, policy, capacity, dedup):
    td, order, tdb, tq, ttd, tord = _plan(qname, q, db)
    cfg = dict(policy=policy, slots=64, assoc=4)
    with RSyncCounter() as rs:
        r = r_engine.count(q, db, td=td, order=order, capacity=capacity,
                           dedup=dedup, cache=RCacheConfig(**cfg))
    with TSyncCounter() as ts:
        t = t_engine.count(tq, tdb, td=ttd, order=tord, capacity=capacity,
                           dedup=dedup, cache=TCacheConfig(**cfg),
                           device="cpu")
    assert t.count == r.count
    _assert_same_run(r, t, rs, ts)
    assert t.counters["expand_calls_torch"] > 0
    assert t.counters["expand_calls_cuda"] == 0


@pytest.mark.parametrize("qname,q,capacity,dedup", EVAL_CASES)
def test_evaluate_matches_reference_in_block_order(db, qname, q, capacity,
                                                   dedup):
    """Evaluation does not use tier 2 (count tables cannot replay tuples),
    so the policy does not enter; the tuples must come in the same order."""
    td, order, tdb, tq, ttd, tord = _plan(qname, q, db)
    with RSyncCounter() as rs:
        r = r_engine.evaluate(q, db, td=td, order=order, backend="jax",
                              capacity=capacity, dedup=dedup)
    with TSyncCounter() as ts:
        t = t_engine.evaluate(tq, tdb, td=ttd, order=tord,
                              capacity=capacity, dedup=dedup, device="cpu")
    assert t.tuples.dtype == np.int32
    np.testing.assert_array_equal(t.tuples, np.asarray(r.tuples))
    assert t.count == r.count > 0
    _assert_same_run(r, t, rs, ts)
    for op in ("expand", "fold", "emit"):
        assert t.counters[f"{op}_calls_cuda"] == 0
    assert t.counters["emit_calls_torch"] > 0


def test_small_capacity_hits_tier2_like_reference(db):
    """Morsel splitting at a small capacity makes later morsels hit earlier
    morsels' inserts; the port must see the same (nonzero) hits."""
    q = bowtie_query()
    td, order, tdb, tq, ttd, tord = _plan("bowtie", q, db)
    r = r_engine.count(q, db, td=td, order=order, capacity=1 << 8,
                       cache=RCacheConfig(policy="setassoc", slots=64))
    t = t_engine.count(tq, tdb, td=ttd, order=tord, capacity=1 << 8,
                       cache=TCacheConfig(policy="setassoc", slots=64),
                       device="cpu")
    assert t.counters["tier2_hits"] == r.counters["tier2_hits"] > 0


def test_dynamic_budgeted_cache_matches_reference(db):
    """The sizing controller resizes the same tables at the same points."""
    q = cycle_query(4)
    td, order, tdb, tq, ttd, tord = _plan("cycle-4", q, db)
    cfg = dict(policy="setassoc", slots=32, assoc=4, dynamic=True,
               budget=512, min_slots=16, resize_interval=2)
    with RSyncCounter() as rs:
        r = r_engine.count(q, db, td=td, order=order, capacity=1 << 8,
                           cache=RCacheConfig(**cfg))
    with TSyncCounter() as ts:
        t = t_engine.count(tq, tdb, td=ttd, order=tord, capacity=1 << 8,
                           cache=TCacheConfig(**cfg), device="cpu")
    assert t.count == r.count
    _assert_same_run(r, t, rs, ts)
    assert t.counters["tier2_slots"] == r.counters["tier2_slots"]


@pytest.mark.parametrize("qname,q", CORPUS[:3], ids=[n for n, _ in CORPUS[:3]])
def test_lftj_matches_reference(db, qname, q):
    td, order, tdb, tq, ttd, tord = _plan(qname, q, db)
    r = r_engine.count(q, db, algorithm="lftj", order=order, td=td,
                       capacity=1 << 8)
    t = t_engine.count(tq, tdb, algorithm="lftj", order=tord, td=ttd,
                       capacity=1 << 8, device="cpu")
    assert t.count == r.count
    assert t.counters["expand_calls_torch"] == r.counters["expand_calls_xla"]
    re = r_engine.evaluate(q, db, algorithm="lftj", backend="jax",
                           order=order, td=td, capacity=1 << 8)
    te = t_engine.evaluate(tq, tdb, algorithm="lftj", order=tord, td=ttd,
                           capacity=1 << 8, device="cpu")
    np.testing.assert_array_equal(te.tuples, np.asarray(re.tuples))


@pytest.mark.parametrize("mode", ["count", "evaluate"])
def test_oversized_rows_split_like_reference(mode):
    """A hub whose candidate run alone exceeds the capacity: the executor
    cuts its guard range into slices of at most C runs and packs the rest;
    the port must cut and pack exactly as the reference does."""
    rng = np.random.default_rng(5)
    hub = np.stack([np.zeros(700, np.int64), np.arange(1, 701)], axis=1)
    db = graph_db(np.concatenate([hub, rng.integers(0, 700, (300, 2))]))
    q = star_query(2)
    td, order, tdb, tq, ttd, tord = _plan(f"hub-{mode}", q, db)
    with RSyncCounter() as rs:
        r = getattr(r_engine, mode)(q, db, td=td, order=order,
                                    capacity=1 << 8,
                                    **({"backend": "jax"}
                                       if mode == "evaluate" else {}))
    with TSyncCounter() as ts:
        t = getattr(t_engine, mode)(tq, tdb, td=ttd, order=tord,
                                    capacity=1 << 8, device="cpu")
    assert t.count == r.count
    if mode == "evaluate":
        np.testing.assert_array_equal(t.tuples, np.asarray(r.tuples))
    _assert_same_run(r, t, rs, ts)
    assert rs.label_counts["expand-split"] > 0
