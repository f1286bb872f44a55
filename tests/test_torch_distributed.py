"""The port's distributed count and evaluation over a 2-rank gloo process
group on the CPU, against the reference's host oracles (``lftj_count``,
``clftj_evaluate``) and, shard by shard, against the reference's static
executor run in this process on the same guard-run slice.

The ranks are two fresh Python processes (they import neither ``jax`` nor
``repro``) that meet through a ``FileStore``; each writes what it saw to a
pickle.  Compared, bit for bit: the summed count and overflow, each rank's
own shard count, the gathered rows (the same on both ranks, in rank
order) of a cold and a warm evaluation, and the warm pass's replay hits
on the bowtie.  One more case runs the bowtie with every kernel knob off
its default (the chain EXPAND with the leapfrog search, the FOLD and EMIT
chains), passed through both factories, against the reference's static
executor under the same knobs (``expand_kernel``, ``fold_kernel`` and
``emit_kernel`` ``"xla"``, ``impl="pallas"``)."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import enable_x64

from repro.core import cache as rc
from repro.core import engine as r_engine
from repro.core.clftj_ref import clftj_evaluate
from repro.core.cq import bowtie_query, cycle_query
from repro.core.db import graph_db
from repro.core.distributed import StaticCLFTJ as RStatic
from repro.core.distributed import _GuardPartition
from repro.core.lftj_ref import lftj_count
from repro.core.schedule import execute_static as r_execute_static
from repro.data.graphs import zipf_graph

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
CAP = 1 << 12
PAY = dict(policy="setassoc", slots=256, assoc=4, cache_payloads=True,
           payload_rows=1 << 12)
QUERIES = {"bowtie": bowtie_query(), "cycle4": cycle_query(4)}
# the chain case: the port's knobs and the reference's names for them
CHAIN_CASE = "bowtie-chain"
CHAIN_KNOBS = dict(expand_kernel="chain", impl="leapfrog",
                   fold_kernel="chain", emit_kernel="chain")
R_CHAIN_KNOBS = dict(expand_kernel="xla", impl="pallas", fold_kernel="xla",
                     emit_kernel="xla")

WORKER = r"""
import pickle, sys
import torch.distributed as dist
rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.convert import from_reference
from repro_torch.core.cache import CacheConfig
from repro_torch.core.distributed import (make_distributed_count,
                                          make_distributed_evaluate,
                                          shard_frontier)
with open(inp, "rb") as f:
    cases = pickle.load(f)
res = {}
for name, case in cases.items():
    db, q, td, order = from_reference(*case["plan"])
    knobs = case["knobs"]
    fn, eng = make_distributed_count(q, td, order, db,
                                     capacity=case["capacity"], device="cpu",
                                     **knobs)
    total, ov = fn()
    local, local_ov = eng.count_fn()(shard_frontier(eng, rank, world))
    run, eng = make_distributed_evaluate(
        q, td, order, db, capacity=case["capacity"],
        cache=CacheConfig(**case["cache"]), device="cpu", **knobs)
    rows1, s1, tables = run()
    rows2, s2, _ = run(tables)
    res[name] = dict(count=int(total), overflow=int(ov), local=int(local),
                     local_overflow=bool(local_ov), rows1=rows1, s1=s1,
                     rows2=rows2, s2=s2,
                     calls={k: v for k, v in eng.stats.items()
                            if "calls" in k})
dist.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module")
def db():
    return graph_db(zipf_graph(14, 80, 1.1, seed=7))


def _plan(q, db):
    td, order = r_engine.plan_query(q, db)
    return td, order, (db.relations, [(a.relation, a.vars)
                                      for a in q.atoms],
                       td.bags, td.parent, order, td.children)


@pytest.fixture(scope="module")
def ranks(db, tmp_path_factory):
    """Run the worker on every rank; returns each rank's results."""
    tmp = tmp_path_factory.mktemp("dist")
    cases = {name: dict(plan=_plan(q, db)[2], capacity=CAP, cache=PAY,
                        knobs={})
             for name, q in QUERIES.items()}
    cases[CHAIN_CASE] = dict(cases["bowtie"], knobs=CHAIN_KNOBS)
    inp = tmp / "cases.pkl"
    inp.write_bytes(pickle.dumps(cases))
    # one thread a rank: ranks that spin on intra-op threads while their
    # peer waits in a collective slow the pair down some tenfold
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD),
         str(tmp / "store"), str(inp), str(tmp / f"rank{r}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(WORLD)]


class _Mesh:
    """Just what the reference's guard partition reads of a mesh."""
    axis_names = ("data",)
    shape = {"data": WORLD}


def _reference_shards(q, db, **knobs):
    """The reference's static engine and its shard frontiers, built in
    this process: ``_GuardPartition.shard_frontier`` under ``vmap`` over a
    named axis of the ranks, with no mesh."""
    td, order, _ = _plan(q, db)
    eng = RStatic(q, td, order, db, capacity=CAP,
                  cache=rc.CacheConfig(**PAY), **knobs)
    part = _GuardPartition(eng, _Mesh(), ("data",))
    with enable_x64():
        F0s = jax.vmap(lambda _: part.shard_frontier(), axis_name="data")(
            jnp.arange(WORLD))
    return eng, [jax.tree.map(lambda x, r=r: x[r], F0s)
                 for r in range(WORLD)]


def _tuples(rows):
    return {tuple(map(int, r)) for r in np.asarray(rows).tolist()}


@pytest.mark.parametrize("qname", list(QUERIES))
def test_distributed_count_matches_oracle_and_reference_shards(db, ranks,
                                                               qname):
    q = QUERIES[qname]
    td, order, _ = _plan(q, db)
    want = lftj_count(q, order, db)
    eng, F0s = _reference_shards(q, db)
    for r, res in enumerate(ranks):
        got = res[qname]
        assert got["count"] == want and got["overflow"] == 0, r
        with enable_x64():
            total, ov, _ = r_execute_static(eng.schedule, eng, F0s[r],
                                            eng.make_tables("count"),
                                            eng.cache_config)
        assert (got["local"], got["local_overflow"]) == (int(total),
                                                         bool(ov)), r
    assert sum(res[qname]["local"] for res in ranks) == want


def _expected_rows(q, db, **knobs):
    """The oracle's tuples, and the reference's static evaluation of each
    shard, cold then warm, concatenated in rank order."""
    td, order, _ = _plan(q, db)
    want = _tuples(np.asarray(clftj_evaluate(q, td, order, db),
                              np.int64).reshape(-1, len(order)))
    eng, F0s = _reference_shards(q, db, **knobs)
    expect = {"rows1": [], "rows2": []}
    with enable_x64():
        for F0 in F0s:
            tables = eng.make_tables("evaluate")
            for key in ("rows1", "rows2"):
                a, v, _, _, _, tables = eng.evaluate_fn()(F0, tables)
                expect[key].append(np.asarray(a)[np.asarray(v)])
    return want, expect


@pytest.mark.parametrize("qname", list(QUERIES))
def test_distributed_evaluate_matches_oracle_cold_and_warm(db, ranks,
                                                           qname):
    """Both passes give the oracle's rows; the rows are the reference's
    static evaluation of each shard, concatenated in rank order; the warm
    pass replays from the tables the cold pass returned."""
    q = QUERIES[qname]
    want, expect = _expected_rows(q, db)
    for r, res in enumerate(ranks):
        got = res[qname]
        for key, stats in (("rows1", got["s1"]), ("rows2", got["s2"])):
            rows = got[key]
            assert rows.dtype == np.int32
            np.testing.assert_array_equal(
                rows, np.concatenate(expect[key]), err_msg=f"{r} {key}")
            assert _tuples(rows) == want and rows.shape[0] == len(want)
            assert stats["count"] == len(want) and not stats["overflow"]
            assert stats["overflow_shards"] == 0
            np.testing.assert_array_equal(rows, ranks[0][qname][key])
        assert got["s1"]["tier2_replay_hits"] == 0
        assert got["calls"]["fold_merged_calls_torch"] > 0
        if qname == "bowtie":
            assert got["s2"]["tier2_replay_hits"] > 0


def test_distributed_chain_path_matches_reference(db, ranks):
    """Both factories take the kernel knobs: with the chain EXPAND and its
    leapfrog search and the FOLD and EMIT chains, the count and the rows
    of both passes equal the reference's static executor under the same
    knobs, shard by shard, and every launch went down the chains."""
    q = QUERIES["bowtie"]
    td, order, _ = _plan(q, db)
    want, expect = _expected_rows(q, db, **R_CHAIN_KNOBS)
    eng, F0s = _reference_shards(q, db, **R_CHAIN_KNOBS)
    for r, res in enumerate(ranks):
        got = res[CHAIN_CASE]
        assert got["count"] == lftj_count(q, order, db) == len(want)
        with enable_x64():
            total, ov, _ = r_execute_static(eng.schedule, eng, F0s[r],
                                            eng.make_tables("count"),
                                            eng.cache_config)
        assert (got["local"], got["local_overflow"]) == (int(total),
                                                         bool(ov)), r
        for key, stats in (("rows1", got["s1"]), ("rows2", got["s2"])):
            np.testing.assert_array_equal(
                got[key], np.concatenate(expect[key]), err_msg=f"{r} {key}")
            np.testing.assert_array_equal(got[key], ranks[0]["bowtie"][key])
            assert stats == ranks[0]["bowtie"]["s1" if key == "rows1"
                                               else "s2"]
        calls = got["calls"]
        assert got["s2"]["tier2_replay_hits"] > 0
        for op in ("expand", "fold", "fold_merged", "emit"):
            assert calls[f"{op}_calls_chain"] > 0, op
            assert calls[f"{op}_calls_torch"] == 0, op
        assert calls["bound_calls_torch"] > 0


def test_factories_raise_without_a_process_group(db):
    import torch.distributed as dist
    from repro_torch.convert import from_reference
    from repro_torch.core.distributed import (make_distributed_count,
                                              make_distributed_evaluate)
    assert not dist.is_initialized()
    tdb, tq, ttd, tord = from_reference(*_plan(bowtie_query(), db)[2])
    for factory in (make_distributed_count, make_distributed_evaluate):
        with pytest.raises(RuntimeError, match="process group"):
            factory(tq, ttd, tord, tdb, capacity=CAP, device="cpu")
