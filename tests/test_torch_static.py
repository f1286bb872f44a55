"""The port's static executor (``StaticCLFTJ`` over
``schedule.execute_static``, on the CPU) against the JAX reference's
``StaticCLFTJ`` on the same database and plan: the corpus of the
reference's own static tests (bowtie, 5-cycle, 4-path on a skewed Zipf
graph), a 5-path whose TD nests one bag inside another (so a merged FOLD's
output is folded again and its exits are sorted first), a tiny capacity
that overflows, tier-1 dedup off, and count-only tables that evaluation
bypasses.

Compared: counts, overflow flags, replay hits, the result rows in order,
and every plane of every tier-2 table (slab and bump pointer included),
after the cold and after the warm pass, and one ``static-eval`` host
fetch per evaluation pass.  Everything is an integer, so the tolerance is
none: equal bit for bit.  A warm pass also starts from the reference's
cold tables (``convert.static_tables_from_reference``)."""
import numpy as np
import pytest
import torch
from jax.experimental import enable_x64

from repro.core import cache as rc
from repro.core import engine as r_engine
from repro.core.clftj_ref import clftj_count
from repro.core.cq import bowtie_query, cycle_query, path_query
from repro.core.db import graph_db
from repro.core.distributed import StaticCLFTJ as RStatic
from repro.core.hostsync import SyncCounter as RSyncCounter
from repro.core.schedule import execute_static as r_execute_static
from repro.data.graphs import zipf_graph
from repro_torch.convert import from_reference, static_tables_from_reference
from repro_torch.core import cache as tc
from repro_torch.core.distributed import StaticCLFTJ as TStatic
from repro_torch.core.hostsync import SyncCounter as TSyncCounter
from repro_torch.core.schedule import execute_static as t_execute_static

CAP = 1 << 13
QUERIES = {"bowtie": bowtie_query(), "cycle5": cycle_query(5),
           "path4": path_query(4), "path5": path_query(5)}
PAY = dict(policy="setassoc", slots=256, assoc=4, cache_payloads=True,
           payload_rows=1 << 13)
COUNT_ONLY = dict(policy="setassoc", slots=256, assoc=4)


@pytest.fixture(scope="module")
def db():
    return graph_db(zipf_graph(16, 110, 1.1, seed=314))


_PLANS = {}


def _plan(qname, db):
    """Reference plan plus the port's copy of db, query and plan."""
    if qname not in _PLANS:
        q = QUERIES[qname]
        td, order = r_engine.plan_query(q, db)
        _PLANS[qname] = (q, td, order) + from_reference(
            db.relations, [(a.relation, a.vars) for a in q.atoms], td.bags,
            td.parent, order, td.children)
    return _PLANS[qname]


def _engines(qname, db, cfg, capacity=CAP, dedup=True):
    q, td, order, tdb, tq, ttd, tord = _plan(qname, db)
    ref = RStatic(q, td, order, db, capacity=capacity, dedup=dedup,
                  cache=rc.CacheConfig(**cfg))
    port = TStatic(tq, ttd, tord, tdb, capacity=capacity, dedup=dedup,
                   cache=tc.CacheConfig(**cfg), device="cpu")
    return ref, port


def _host_tables(tables):
    return {k: tuple(np.asarray(x) for x in v) for k, v in tables.items()}


# the planes' dtypes: keys, vals, used, stamp, cost, then pay_off,
# pay_len, slab and bump (the reference's bump turns int64 after its
# first allocation; its values are compared all the same)
DTYPES = (torch.int64, torch.int64, torch.bool, torch.int32, torch.int64,
          torch.int32, torch.int32, torch.int32, torch.int32)


def _same_tables(rt, tt, what):
    assert sorted(rt) == sorted(tt), what
    for node in rt:
        assert len(rt[node]) == len(tt[node]), (what, node)
        for i, (a, b) in enumerate(zip(rt[node], tt[node])):
            assert b.dtype == DTYPES[i], (what, node, i)
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(a),
                err_msg=f"{what}: table {node} plane {i}")


def _same_eval_pass(ref, port, rtables, ttables, what):
    """One ``evaluate_static`` pass of each engine: the same rows in the
    same order, the same stats and tables, one ``static-eval`` fetch."""
    with enable_x64(), RSyncCounter() as rs:
        rrows, rstats, rtables = ref.evaluate_static(rtables)
    with TSyncCounter() as ts:
        trows, tstats, ttables = port.evaluate_static(ttables)
    assert trows.dtype == np.int32
    np.testing.assert_array_equal(trows, np.asarray(rrows), err_msg=what)
    assert tstats == rstats, what
    assert ts.label_counts == rs.label_counts == {"static-eval": 1}, what
    _same_tables(rtables, ttables, what)
    return rstats, rtables, ttables


EVAL_CASES = [
    pytest.param(qn, PAY, CAP, True, id=qn) for qn in QUERIES] + [
    pytest.param("bowtie", PAY, CAP, False, id="bowtie-nodedup"),
    # the result cannot fit the chunk: the cold pass overflows in the
    # replay, the warm pass in the splice
    pytest.param("bowtie", PAY, 1 << 6, True, id="bowtie-overflow"),
    pytest.param("bowtie", COUNT_ONLY, CAP, True, id="bowtie-count-only"),
]


@pytest.mark.parametrize("qname,cfg,capacity,dedup", EVAL_CASES)
def test_static_evaluate_cold_and_warm_match_reference(db, qname, cfg,
                                                       capacity, dedup):
    ref, port = _engines(qname, db, cfg, capacity, dedup)
    with enable_x64():
        rtables = ref.make_tables("evaluate")
    ttables = port.make_tables("evaluate")
    _same_tables(rtables, ttables, "fresh")
    cold, rtables, ttables = _same_eval_pass(ref, port, rtables, ttables,
                                             "cold")
    warm, _, _ = _same_eval_pass(ref, port, rtables, ttables, "warm")
    st = port.stats
    assert st["fold_calls_cuda"] == st["expand_calls_cuda"] == 0
    assert st["emit_calls_torch"] == 2
    overflow = capacity < CAP
    assert cold["overflow"] == warm["overflow"] == overflow
    if cfg is COUNT_ONLY:
        # bypassed: no probe, no splice, the replay-only FOLD
        assert len(next(iter(ttables.values()))) == 5
        assert warm["tier2_replay_hits"] == 0
        assert st["fold_merged_calls_torch"] == 0 < st["fold_calls_torch"]
    else:
        assert st["fold_merged_calls_torch"] > 0
        assert cold["tier2_replay_hits"] == 0
        if not overflow:
            q, td, order = _plan(qname, db)[:3]
            want = clftj_count(q, td, order, db)
            assert cold["count"] == warm["count"] == want
    if qname == "bowtie" and not overflow:
        assert warm["tier2_replay_hits"] > 0 or cfg is COUNT_ONLY
    if qname == "path5":
        # the TD nests node 3 in node 2: node 2's fold gets the merged
        # output of node 3's, which is not sorted by orig
        assert st["fold_sorted_exits"] > 0
    else:
        assert st["fold_sorted_exits"] == 0


@pytest.mark.parametrize("qname,tables", [
    pytest.param(qn, "count", id=qn) for qn in QUERIES] + [
    pytest.param("bowtie", "evaluate", id="bowtie-payload-tables")])
def test_static_count_matches_reference(db, qname, tables):
    """Count mode through ``execute_static`` itself, so the tables come
    back: the count, the overflow flag and every table plane; with
    payload tables the count insert writes the -1 sentinel into them."""
    ref, port = _engines(qname, db, PAY)
    with enable_x64():
        rt = ref.make_tables(tables)
        rtotal, rov, rt = r_execute_static(ref.schedule, ref,
                                           ref.initial_frontier(), rt,
                                           ref.cache_config)
        rtotal, rov = int(rtotal), bool(rov)
    ttotal, tov, tt = t_execute_static(port.schedule, port,
                                       port.initial_frontier(),
                                       port.make_tables(tables),
                                       port.cache_config)
    assert (int(ttotal), bool(tov)) == (rtotal, rov)
    assert not rov and ttotal.dtype == torch.int64
    _same_tables(rt, tt, "count")
    q, td, order = _plan(qname, db)[:3]
    assert rtotal == clftj_count(q, td, order, db)
    total, ov = port.count_fn()(port.initial_frontier())
    assert (int(total), bool(ov)) == (rtotal, rov)


def test_static_warm_pass_from_reference_tables(db):
    """The reference's cold tables, carried across, serve the port's warm
    pass exactly as they serve the reference's own."""
    ref, port = _engines("bowtie", db, PAY)
    with enable_x64():
        _, cold, rtables = ref.evaluate_static()
    ttables = static_tables_from_reference(_host_tables(rtables),
                                           device="cpu")
    _same_tables(rtables, ttables, "converted")
    warm, _, _ = _same_eval_pass(ref, port, rtables, ttables,
                                 "warm from reference tables")
    assert cold["tier2_replay_hits"] == 0 < warm["tier2_replay_hits"]
    with pytest.raises(ValueError):
        static_tables_from_reference({1: _host_tables(rtables)[1][:4]},
                                     device="cpu")
