"""Streaming evaluation of the port (``evaluate_stream``, on the CPU):

* the :class:`AsyncFetchQueue` contract — FIFO arrival order, the
  in-flight bound, drain, per-pass accounting, double-buffered staging,
  and async issues counted apart from blocking syncs;
* the stream reassembles to the one-shot result in the same order, for
  the vanilla engine and the cached engine with payloads (cold and warm),
  through the engine and through the ``engine.evaluate_stream`` facade;
* on the bowtie, interior streaming issues more async copies than
  tail-only streaming, and both issue exactly as many async and blocking
  fetches, label by label, as the JAX reference (``backend="jax"``);
* an abandoned stream still finalizes its stats.

Everything compared is an integer: equal bit for bit."""
import numpy as np
import pytest
import torch

from repro.core import engine as r_engine
from repro.core.cache import CacheConfig as RCacheConfig
from repro.core.cached_frontier import JaxCachedTrieJoin
from repro.core.cq import bowtie_query, cycle_query, path_query
from repro.core.db import graph_db
from repro.core.hostsync import SyncCounter as RSyncCounter
from repro_torch.convert import from_reference
from repro_torch.core import engine as t_engine
from repro_torch.core.cache import CacheConfig as TCacheConfig
from repro_torch.core.cached_frontier import CachedTrieJoin
from repro_torch.core.frontier import TrieJoin
from repro_torch.core.hostsync import (AsyncFetchQueue, SyncCounter,
                                       device_get, device_get_async)

CAP = 1 << 8
PAY = dict(policy="setassoc", slots=64, assoc=4, cache_payloads=True,
           payload_rows=1 << 12)


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    return graph_db(rng.integers(0, 12, size=(80, 2)))


def _port(q, db):
    """The port's copy of db, query and the reference's plan."""
    td, order = r_engine.plan_query(q, db)
    return (td, order) + from_reference(
        db.relations, [(a.relation, a.vars) for a in q.atoms], td.bags,
        td.parent, order, td.children)


# ---------------------------------------------------------------------------
# AsyncFetchQueue
# ---------------------------------------------------------------------------

def test_async_queue_fifo_bound_and_drain():
    q = AsyncFetchQueue(max_in_flight=3)
    got = []
    for i in range(10):
        got.extend(q.put(torch.full((4,), i), f"blk{i}"))
        assert q.in_flight <= 3
    got.extend(q.drain())
    assert q.in_flight == 0 and q.issued == 10 and q.high_water == 3
    assert [int(x[0]) for x in got] == list(range(10))
    with pytest.raises(ValueError):
        AsyncFetchQueue(max_in_flight=0)


def test_async_queue_poll_preserves_order_and_copies_at_issue():
    q = AsyncFetchQueue(max_in_flight=8)
    src = torch.zeros(2, dtype=torch.int32)
    for i in range(5):
        src.fill_(i)  # later writes must not reach an issued fetch
        assert q.put({"x": src, "k": torch.tensor(i)}, "b") == []
    out = list(q.poll()) + list(q.drain())
    assert [int(d["x"][0]) for d in out] == list(range(5))
    assert [int(d["k"]) for d in out] == list(range(5))


def test_async_issues_counted_separately_from_blocking_syncs():
    with SyncCounter() as sc:
        h = device_get_async(torch.arange(8), "async-lbl")
        device_get(torch.arange(8), "blocking-lbl")
        assert h.ready()
        np.testing.assert_array_equal(h.get(), np.arange(8))
    assert sc.count == 1 and sc.async_count == 1
    assert sc.label_counts == {"async-lbl": 1, "blocking-lbl": 1}
    assert len(sc.events) == 2  # completing h added no event


def test_async_queue_reset_and_double_buffer():
    q = AsyncFetchQueue(max_in_flight=2, double_buffer=True)
    vals, ids = [], []
    for i in range(7):
        for done in q.put(torch.full((8,), i, dtype=torch.int32), "a"):
            vals.append(int(done[0]))  # read at receipt: buffer is reused
            ids.append(id(done))
    for done in q.drain():
        vals.append(int(done[0]))
        ids.append(id(done))
    assert vals == list(range(7))
    assert len(set(ids)) <= 2, "staging arrays must be recycled"
    assert q.issued == 7 and q.labels["a"] == 7 and q.high_water == 2
    q.reset()
    assert q.issued == 0 and q.high_water == 0 and not q.labels
    q.put(torch.zeros(3), "b")
    with pytest.raises(RuntimeError, match="in flight"):
        q.reset()
    list(q.drain())
    q.reset()


# ---------------------------------------------------------------------------
# The stream against one-shot evaluation and the reference
# ---------------------------------------------------------------------------

def test_stream_matches_one_shot_lftj(db):
    q = cycle_query(4)
    order = sorted(q.variables)
    one = list(TrieJoin(q, order, db, capacity=CAP,
                        device="cpu").evaluate())
    eng = TrieJoin(q, order, db, capacity=CAP, device="cpu",
                   emit_in_flight=2)
    st = list(eng.evaluate_stream())
    assert len(one) == len(st) > 2
    for a, b in zip(one, st):
        np.testing.assert_array_equal(a, b)
    eq = eng.last_executor.emit_queue
    assert eq.max_in_flight == 2 and 1 <= eq.high_water <= 2
    assert eq.issued == eng.last_executor.emitted_blocks
    assert eq.in_flight == 0


@pytest.mark.parametrize("interior", [True, False],
                         ids=["interior", "tail-only"])
def test_stream_matches_one_shot_and_reference_counts(db, interior):
    """Cold and warm passes with payloads: the stream gives the one-shot
    blocks in the same order, and the same async and blocking fetches,
    label by label, as the reference's stream."""
    q = bowtie_query()
    td, order, tdb, tq, ttd, tord = _port(q, db)
    ref = JaxCachedTrieJoin(q, td, order, db, capacity=CAP,
                            cache=RCacheConfig(**PAY),
                            stream_interior=interior)
    port = CachedTrieJoin(tq, ttd, tord, tdb, capacity=CAP,
                          cache=TCacheConfig(**PAY), device="cpu",
                          stream_interior=interior)
    one = CachedTrieJoin(tq, ttd, tord, tdb, capacity=CAP,
                         cache=TCacheConfig(**PAY), device="cpu")
    for run in ("cold", "warm"):
        with RSyncCounter() as rs:
            rb = [np.array(b) for b in ref.evaluate_stream()]
        with SyncCounter() as ts:
            tb = list(port.evaluate_stream())
        ob = list(one.evaluate())
        assert len(tb) == len(rb) == len(ob) > 0, run
        for a, b, c in zip(tb, rb, ob):
            np.testing.assert_array_equal(a, b, err_msg=run)
            np.testing.assert_array_equal(a, c, err_msg=run)
        assert (ts.count, ts.async_count) == (rs.count, rs.async_count), run
        assert ts.label_counts == rs.label_counts, run
        assert ts.label_counts["emit-stream"] == len(tb)
        assert (ts.label_counts["replay-plan-async"] > 0) == interior
        for k in ("tier2_replay_hits", "tier2_slab_rows", "tier2_inserts"):
            assert port.stats[k] == ref.stats[k] == one.stats[k], (run, k)
    assert port.stats["tier2_replay_hits"] > 0


def test_interior_streaming_issues_more_async_than_tail_only(db):
    """On the recurring bowtie, warm: interior streaming's extra async
    issues are the per-morsel replay plans; the blocks are the same."""
    q = bowtie_query()
    _, _, tdb, tq, ttd, tord = _port(q, db)

    def run(interior):
        eng = CachedTrieJoin(tq, ttd, tord, tdb, capacity=CAP,
                             cache=TCacheConfig(**PAY), device="cpu",
                             stream_interior=interior)
        list(eng.evaluate())  # warm: fills the slab
        with SyncCounter() as sc:
            blocks = list(eng.evaluate_stream())
        return blocks, sc

    interior, sc_i = run(True)
    tail, sc_t = run(False)
    assert len(interior) == len(tail) > 0
    for a, b in zip(interior, tail):
        np.testing.assert_array_equal(a, b)
    assert sc_i.async_count > sc_t.async_count
    assert sc_i.label_counts["replay-plan-async"] > 0
    assert sc_t.label_counts["replay-plan-async"] == 0


def test_abandoned_stream_still_finalizes_stats(db):
    q = bowtie_query()
    _, _, tdb, tq, ttd, tord = _port(q, db)
    eng = CachedTrieJoin(tq, ttd, tord, tdb, capacity=CAP,
                         cache=TCacheConfig(**PAY), device="cpu")
    list(eng.evaluate())
    list(eng.evaluate())
    warm_hits = eng.stats["tier2_replay_hits"]
    before = eng.stats["emit_calls_torch"]
    gen = eng.evaluate_stream()
    next(gen)
    gen.close()  # abandon after the first block
    assert eng.stats["tier2_replay_hits"] > warm_hits
    assert eng.stats["emit_calls_torch"] > before
    # the engine's queue is reusable after an abandoned stream
    blocks = list(eng.evaluate_stream())
    one = list(eng.evaluate())
    assert len(blocks) == len(one)
    for a, b in zip(blocks, one):
        np.testing.assert_array_equal(a, b)


def test_facade_stream_result_totals(db):
    q = path_query(4)
    kw = dict(capacity=CAP, cache=TCacheConfig(**PAY), device="cpu")
    res = t_engine.evaluate(q, db, **kw)
    rs = t_engine.evaluate_stream(q, db, emit_in_flight=2, **kw)
    assert rs.result is None  # not exhausted yet
    rows = np.concatenate(list(rs))
    np.testing.assert_array_equal(rows, res.tuples)
    assert rs.result.count == res.count > 0 and rs.result.tuples is None
    assert rs.result.counters.keys() == res.counters.keys()
    assert rs.result.order == res.order
    assert rs.result.tier2_replay_hits == res.tier2_replay_hits
    with pytest.raises(ValueError, match="algorithm"):
        t_engine.evaluate_stream(q, db, algorithm="ytd", device="cpu")
