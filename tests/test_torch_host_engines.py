"""The port's host engines (``repro_torch.core``: ``lftj_ref.LFTJ``,
``clftj_ref.CLFTJ`` with its ``CachePolicy``, ``yannakakis.YTD`` and the
brute-force oracle) against the reference's, on the corpora of the
reference's ``tests/test_join_engines.py`` (its five queries on the
``small_graphs`` databases) and ``tests/test_property_joins.py`` (its
seeded random databases and queries), with the reference's plan carried
across by ``repro_torch.convert``.

Compared, exactly: counts, the evaluated tuples in the engines' own order,
and the ``Counters`` snapshots (the paper's memory-access proxies); the
cache-policy variants of the host CLFTJ (admission threshold, bounded
capacity under each eviction flavour, node restriction, and
``CachePolicy.from_cache_config``), with the cache's final size; and the
facade's ``backend="ref"`` (``algorithm`` clftj, lftj, ytd) against the
reference's facade.  Everything is an integer: no tolerance."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import bruteforce as r_bf
from repro.core import clftj_ref as r_clftj
from repro.core import engine as r_engine
from repro.core import lftj_ref as r_lftj
from repro.core import yannakakis as r_ytd
from repro.core.cache import CacheConfig as RCacheConfig
from repro.core.cq import (cycle_query, lollipop_query, path_query,
                           random_graph_query)
from repro.core.db import Counters as RCounters
from repro.core.decompose import choose_plan
from repro_torch.convert import from_reference
from repro_torch.core import bruteforce as t_bf
from repro_torch.core import clftj_ref as t_clftj
from repro_torch.core import engine as t_engine
from repro_torch.core import lftj_ref as t_lftj
from repro_torch.core import yannakakis as t_ytd
from repro_torch.core.cache import CacheConfig as TCacheConfig
from repro_torch.core.db import Counters as TCounters
from test_property_joins import CORPUS, _make_case

REF = SimpleNamespace(lftj=r_lftj, clftj=r_clftj, ytd=r_ytd, bf=r_bf,
                      Counters=RCounters)
PORT = SimpleNamespace(lftj=t_lftj, clftj=t_clftj, ytd=t_ytd, bf=t_bf,
                       Counters=TCounters)
# tests/test_join_engines.py's queries
QUERIES = [path_query(4), cycle_query(4), cycle_query(5),
           lollipop_query(3, 2), random_graph_query(5, 0.5, seed=2)]
# CachePolicy fields: tests/test_join_engines.py's variants, and a bound
# under every eviction flavour
POLICIES = {
    "threshold-2": dict(support_threshold=2),
    "threshold-3-cap-4-lru": dict(support_threshold=3, capacity=4,
                                  evict="lru"),
    "cap-4": dict(capacity=4),
    "cap-2-none": dict(capacity=2, evict="none"),
    "cap-2-lru": dict(capacity=2, evict="lru"),
    "cap-2-cost": dict(capacity=2, evict="cost"),
    "cap-0": dict(capacity=0),
    "node-1": dict(enabled_nodes=frozenset({1})),
}
# device cache configs the host CLFTJ maps onto a CachePolicy
CACHE_CONFIGS = {
    "direct-4": dict(policy="direct", slots=4),
    "setassoc-8": dict(policy="setassoc", slots=8, assoc=2),
    "costaware-4": dict(policy="costaware", slots=4, assoc=2),
    "budget-3": dict(policy="setassoc", slots=64, budget=3),
    "node-1": dict(slots=16, enabled_nodes=frozenset({1})),
}


def _port_case(q, db):
    """The reference's plan, and the port's copy of db, query and plan."""
    td, order = choose_plan(q, db.stats())
    return (td, order) + from_reference(
        db.relations, [(a.relation, a.vars) for a in q.atoms], td.bags,
        td.parent, order, td.children)


def _runs(m, q, td, order, db, policy=None, clftj_only=False):
    """The host engines of package ``m`` (every one, or the CLFTJ alone),
    count and evaluation: each result with its Counters snapshot."""
    out = {}

    def run(name, fn):
        c = m.Counters()
        out[name] = (fn(c), c.snapshot())

    run("clftj-count",
        lambda c: m.clftj.CLFTJ(q, td, order, db, policy, c).count())
    run("clftj-eval",
        lambda c: list(m.clftj.CLFTJ(q, td, order, db, policy, c)
                       .evaluate()))
    if clftj_only:
        return out
    run("lftj-count", lambda c: m.lftj.LFTJ(q, order, db, c).count())
    run("lftj-eval",
        lambda c: list(m.lftj.LFTJ(q, order, db, c).evaluate()))
    run("ytd-count", lambda c: m.ytd.YTD(q, td, db, c).count())
    run("ytd-eval", lambda c: m.ytd.YTD(q, td, db, c).evaluate())
    out["bf"] = (m.bf.brute_force_evaluate(q, db), None)
    return out


def _assert_same(q, db, rpolicy=None, tpolicy=None, clftj_only=False):
    td, order, tdb, tq, ttd, tord = _port_case(q, db)
    r = _runs(REF, q, td, order, db, rpolicy, clftj_only)
    t = _runs(PORT, tq, ttd, tord, tdb, tpolicy, clftj_only)
    assert t.keys() == r.keys()
    for name in r:
        assert t[name] == r[name], name
    if clftj_only:
        want = r_lftj.lftj_count(q, order, db)
    else:
        want = len(r["bf"][0])
        for name in ("lftj-count", "ytd-count"):
            assert t[name][0] == want, name
        for name in ("lftj-eval", "ytd-eval"):
            assert len(t[name][0]) == want, name
    assert t["clftj-count"][0] == len(t["clftj-eval"][0]) == want
    return t


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_join_engines_corpus_matches_reference(small_graphs, qi):
    for db in small_graphs:
        _assert_same(QUERIES[qi], db)


@pytest.mark.parametrize("seed", CORPUS)
def test_property_corpus_matches_reference(seed):
    db, q = _make_case(seed)
    _assert_same(q, db)


@pytest.mark.parametrize("name", list(POLICIES))
def test_cache_policies_match_reference(small_graphs, name):
    """The host CLFTJ under every policy variant: the same results and
    counters as the reference's (and LFTJ's count), the cache's final
    size equal and within its bound."""
    q = cycle_query(5)
    for db in small_graphs[:2]:
        kw = POLICIES[name]
        t = _assert_same(q, db, r_clftj.CachePolicy(**kw),
                         t_clftj.CachePolicy(**kw), clftj_only=True)
        td, order, tdb, tq, ttd, tord = _port_case(q, db)
        reng = r_clftj.CLFTJ(q, td, order, db, r_clftj.CachePolicy(**kw))
        teng = t_clftj.CLFTJ(tq, ttd, tord, tdb, t_clftj.CachePolicy(**kw))
        assert teng.count() == reng.count() == t["clftj-count"][0]
        assert len(teng.cache) == len(reng.cache)
        if kw.get("capacity") is not None:
            assert len(teng.cache) <= kw["capacity"]
    if name == "threshold-2":
        assert t["clftj-count"][1]["cache_skipped"] > 0


@pytest.mark.parametrize("name", list(CACHE_CONFIGS))
def test_policy_from_cache_config_matches_reference(small_graphs, name):
    kw = CACHE_CONFIGS[name]
    rp = r_clftj.CachePolicy.from_cache_config(RCacheConfig(**kw))
    tp = t_clftj.CachePolicy.from_cache_config(TCacheConfig(**kw))
    assert vars(tp) == vars(rp)
    _assert_same(cycle_query(5), small_graphs[1], rp, tp, clftj_only=True)


@pytest.mark.parametrize("algorithm", ["clftj", "lftj", "ytd"])
def test_facade_ref_backend_matches_reference(small_graphs, algorithm):
    """``engine.count`` / ``evaluate`` with ``backend="ref"``: the same
    count, tuples (int64, the reference's column order) and counters as
    the reference's facade; the host engines need no card, so the
    default ``device="cuda"`` does not enter."""
    q = cycle_query(4)
    db = small_graphs[2]
    td, order, tdb, tq, ttd, tord = _port_case(q, db)
    for mode in ("count", "evaluate"):
        r = getattr(r_engine, mode)(q, db, algorithm=algorithm,
                                    backend="ref", td=td, order=order)
        t = getattr(t_engine, mode)(tq, tdb, algorithm=algorithm,
                                    backend="ref", td=ttd, order=tord)
        assert (t.count, t.backend, t.device) == (r.count, "ref", "cpu")
        assert t.counters == r.counters and t.fold_paths == {}
        if mode == "evaluate":
            assert t.tuples.dtype == np.int64
            np.testing.assert_array_equal(t.tuples, r.tuples)
    assert t.count == len(r_bf.brute_force_evaluate(q, db)) > 0


def test_facade_maps_cache_onto_policy_like_reference(small_graphs):
    """``count(backend="ref", cache=...)`` caches under the policy the
    cache config maps to; an explicit ``policy`` wins."""
    q = cycle_query(5)
    db = small_graphs[2]
    td, order, tdb, tq, ttd, tord = _port_case(q, db)
    kw = dict(policy="costaware", slots=3, assoc=1)
    r = r_engine.count(q, db, backend="ref", td=td, order=order,
                       cache=RCacheConfig(**kw))
    t = t_engine.count(tq, tdb, backend="ref", td=ttd, order=tord,
                       cache=TCacheConfig(**kw))
    assert t.count == r.count and t.counters == r.counters
    assert t.counters["cache_skipped"] > 0
    free = t_engine.count(tq, tdb, backend="ref", td=ttd, order=tord,
                          cache=TCacheConfig(**kw),
                          policy=t_clftj.CachePolicy())
    assert free.count == t.count
    assert free.counters["cache_skipped"] == 0


def test_facade_refuses_what_the_reference_refuses(small_graphs):
    from repro_torch.core.db import Database
    db = Database(dict(small_graphs[0].relations))
    q = cycle_query(4)
    with pytest.raises(ValueError, match="ytd"):
        t_engine.count(q, db, algorithm="ytd", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        t_engine.count(q, db, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="evaluate_stream"):
        t_engine.evaluate_stream(q, db, backend="ref")
    with pytest.raises(ValueError, match="evaluate_stream"):
        t_engine.evaluate_stream(q, db, algorithm="ytd", backend="ref")
    res = t_engine.count(q, db, algorithm="ytd", backend="ref")
    assert res.count == len(t_bf.brute_force_evaluate(q, db))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_engine.count(q, db)
