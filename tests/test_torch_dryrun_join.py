"""The join's dry-run (``launch/dryrun_join.py``): the distributed count
split over eight shards on the CPU against the whole count and the
reference's, and the record of rank 0 of a fake group."""
import numpy as np
import pytest

from repro.core.cq import cycle_query as ref_cycle_query
from repro.core.cq import path_query as ref_path_query
from repro.core.db import graph_db as ref_graph_db
from repro.core.lftj_ref import lftj_count
from repro.data.graphs import barabasi_albert as ref_barabasi_albert
from repro_torch.core import CacheConfig, engine
from repro_torch.core.distributed import StaticCLFTJ, shard_frontier
from repro_torch.data.graphs import barabasi_albert
from repro_torch.launch import dryrun_join

WORLD = 8
GRAPH = (80, 3, 11)           # a small Barabási-Albert graph


@pytest.mark.parametrize("query", ["5-cycle", "5-path"])
def test_shards_sum_to_the_whole_count(query):
    """The eight shards' counts (``shard_frontier`` by index, each a static
    pass of its own) sum to ``engine.count`` and to the reference's
    LFTJ count of the same query on the same graph (the port's
    Barabási-Albert draw, edge for edge the reference's); no shard
    overflows (2^13 rows: room for the 5-cycle's largest shard here)."""
    q, db, td, order = dryrun_join.join_inputs(query, GRAPH)
    eng = StaticCLFTJ(q, td, order, db, capacity=1 << 13,
                      cache=CacheConfig(policy="direct", slots=1 << 15),
                      device="cpu")
    fn = eng.count_fn()
    total = 0
    for i in range(WORLD):
        count, overflow = fn(shard_frontier(eng, i, WORLD))
        assert not bool(overflow), i
        total += int(count)
    n, m, seed = GRAPH
    rq = ref_cycle_query(5) if query == "5-cycle" else ref_path_query(5)
    edges = ref_barabasi_albert(n, m, seed=seed)
    assert np.array_equal(barabasi_albert(n, m, seed=seed), edges)
    want = lftj_count(rq, order, ref_graph_db(edges))
    assert total == engine.count(q, db, device="cpu").count == want > 0


def test_dryrun_join_record():
    """``run_join`` on a fake group of 8 ranks, on the CPU: a record with
    every field, rank 0's shard count equal to that shard's own pass
    (the fake all-reduce added nothing), the one all-reduce of two int64
    sums counted, the tables and a frontier chunk's bytes, and no peak
    on the CPU (not measured)."""
    rec = dryrun_join.run_join(query="5-path", device="cpu", world=WORLD,
                               graph=GRAPH)
    assert set(rec) == {"kind", "query", "mesh", "n_devices", "capacity",
                        "cache_slots", "device", "status", "shard_count",
                        "shard_overflow", "count_is", "pass_s", "memory",
                        "collectives", "collective_bytes_weighted"}
    assert rec["status"] == "ok" and rec["n_devices"] == WORLD
    q, db, td, order = dryrun_join.join_inputs("5-path", GRAPH)
    eng = StaticCLFTJ(q, td, order, db, capacity=1 << 14,
                      cache=CacheConfig(policy="direct", slots=1 << 15),
                      device="cpu")
    want, _ = eng.count_fn()(shard_frontier(eng, 0, WORLD))
    assert rec["shard_count"] == int(want) > 0
    assert not rec["shard_overflow"]
    assert rec["collectives"]["all-reduce"] == 16
    assert rec["collective_bytes_weighted"] == 32
    mem = rec["memory"]
    assert mem["peak_device_bytes"] is None
    assert mem["table_bytes"] > 0 and mem["frontier_bytes"] > 0
