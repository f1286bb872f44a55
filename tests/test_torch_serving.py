"""The port's serving layer (``repro_torch.serve``, on the CPU) against the
reference's (``repro.serve``): the counterparts of ``tests/test_serving.py``
on the same database (``zipf_graph(16, 110, 1.1, seed=314)``) and the
same engine config (the reference's ``TPU_SERVE`` with small tables,
carried across by ``convert.engine_config_from_reference``):

* canonical keys equal to the reference's on its corpus, and the key
  invariants;
* the plan cache: an isomorphic lookup hits one engine whose cold and
  warm passes give the reference's rows bit for bit; LRU eviction and the
  cold regime hit and miss as the reference's do; config keys separate
  plans;
* sessions: concurrent streams equal the reference's oracle; admission
  rejection and recovery; worker syncs stay out of the client's counter;
  results carry the client's column names;
* snapshots: round trip in process and from another process (a fresh
  ``python -c`` child that imports only the port); unusable files and
  other configs start cold; a stale slab epoch or a block past it
  flushes only the payloads; a rejected import leaves the table as it
  was;
* table states: ``export_state`` planes equal the reference's after the
  same queries, and carry across both ways.

The reference's two autotune tests have no counterpart: the port has no
autotune, and its snapshot carries tables only."""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import enable_x64

from repro.configs import paper_clftj as r_configs
from repro.core import engine as r_engine
from repro.core.cache import DeviceCache as RDeviceCache
from repro.core.cq import CQ as RCQ, Atom as RAtom
from repro.core.cq import cycle_query, path_query, random_graph_query
from repro.core.db import graph_db
from repro.core.decompose import choose_plan as r_choose_plan
from repro.data.graphs import zipf_graph
from repro.serve import PlanCache as RPlanCache
from repro.serve import canonical_cq as r_canonical_cq
from repro.serve import canonical_td as r_canonical_td
from repro.serve.canonical import rename_query as r_rename_query
from repro_torch.configs import paper_clftj as t_configs
from repro_torch.convert import (engine_config_from_reference,
                                 table_from_reference)
from repro_torch.core.cq import CQ, Atom
from repro_torch.core.db import Database
from repro_torch.core.hostsync import SyncCounter
from repro_torch.core.td import TreeDecomposition
from repro_torch.serve import (JoinServer, PlanCache, SessionRejected,
                               canonical_cq, canonical_td, config_key)

ROOT = Path(__file__).resolve().parents[1]
R_CFG = dataclasses.replace(r_configs.TPU_SERVE, cache_slots=512,
                            cache_assoc=4, payload_rows=1 << 13,
                            frontier_capacity=1 << 14)
CFG = engine_config_from_reference(R_CFG)


@pytest.fixture(scope="module")
def rdb():
    return graph_db(zipf_graph(16, 110, 1.1, seed=314))


@pytest.fixture(scope="module")
def db(rdb):
    return Database(dict(rdb.relations))


def _port(q: RCQ) -> CQ:
    """The port's copy of a reference query."""
    return CQ(tuple(Atom(a.relation, tuple(a.vars)) for a in q.atoms))


def _scramble(q: RCQ, seed: int) -> RCQ:
    """A random isomorphic copy: variables renamed, atoms shuffled."""
    rng = np.random.default_rng(seed)
    variables = list(q.variables)
    names = [f"s{i}" for i in rng.permutation(len(variables))]
    atoms = list(r_rename_query(q, dict(zip(variables, names))).atoms)
    rng.shuffle(atoms)
    return RCQ(tuple(atoms))


def _rows(order, blocks):
    """Result rows as a set, columns sorted by variable name."""
    idx = [list(order).index(v) for v in sorted(order)]
    if not blocks:
        return set()
    rows = np.concatenate(blocks, axis=0)[:, idx]
    return {tuple(map(int, r)) for r in rows.tolist()}


def _oracle(q: RCQ, rdb):
    """The reference's host oracle (``engine.evaluate``, backend "ref")."""
    res = r_engine.evaluate(q, rdb)
    return _rows(res.order, [np.asarray(res.tuples)])


def _server(db, cfg=CFG, **kw):
    return JoinServer(db, cfg, device="cpu", **kw)


def _corpus_query(seed: int) -> RCQ:
    rng = np.random.default_rng(seed)
    kind = int(rng.integers(0, 3))
    if kind == 0:
        return path_query(int(rng.integers(2, 6)))
    if kind == 1:
        return cycle_query(int(rng.integers(3, 6)))
    return random_graph_query(int(rng.integers(3, 6)), 0.6, seed=seed)


# ---------------------------------------------------------------------------
# canonical keys
# ---------------------------------------------------------------------------

def test_canonical_keys_equal_reference_on_corpus():
    for seed in range(40):
        q = _corpus_query(seed)
        s = _scramble(q, seed * 7 + 1)
        canon, pos, key = canonical_cq(_port(q))
        r_canon, r_pos, r_key = r_canonical_cq(q)
        assert key == r_key and pos == r_pos
        assert canon == _port(r_canon)
        # isomorphism invariance and idempotence, as the reference pins
        assert canonical_cq(_port(s))[2] == key
        canon3, pos3, key3 = canonical_cq(canon)
        assert key3 == key and canon3 == canon
        assert all(pos3[f"v{i}"] == i for i in range(len(q.variables)))


def test_canonical_td_keys_equal_reference(rdb):
    for q in (path_query(4), cycle_query(5)):
        td, _ = r_choose_plan(q, rdb.stats())
        _, pos, _ = r_canonical_cq(q)
        rtd, r_key = r_canonical_td(td, pos)
        ttd, key = canonical_td(TreeDecomposition(list(td.bags),
                                                  list(td.parent)), pos)
        assert key == r_key
        assert ttd.bags == rtd.bags and ttd.parent == rtd.parent


def test_config_maps_from_reference():
    pairs = [("TPU_DEFAULT", "GPU_DEFAULT"), ("TPU_SETASSOC", "GPU_SETASSOC"),
             ("TPU_COST_AWARE", "GPU_COST_AWARE"),
             ("TPU_ADAPTIVE", "GPU_ADAPTIVE"),
             ("TPU_EVAL_REPLAY", "GPU_EVAL_REPLAY"),
             ("TPU_STREAM_EMIT", "GPU_STREAM_EMIT"),
             ("TPU_SERVE", "GPU_SERVE"),
             ("TPU_FUSED_EXPAND", "GPU_FUSED_EXPAND"),
             ("TPU_FUSED_EXPAND", "GPU_DEFAULT"),
             ("PAPER_FAITHFUL", "PAPER_FAITHFUL"),
             ("BOUNDED_100K", "BOUNDED_100K")]
    for r_name, t_name in pairs:
        assert engine_config_from_reference(
            getattr(r_configs, r_name)) == getattr(t_configs, t_name)
    chain = engine_config_from_reference(dataclasses.replace(
        r_configs.TPU_DEFAULT, impl="pallas", expand_kernel="xla",
        fold_kernel="xla", emit_kernel="xla"))
    assert (chain.impl, chain.expand_kernel, chain.fold_kernel,
            chain.emit_kernel) == ("leapfrog", "chain", "chain", "chain")
    host = engine_config_from_reference(dataclasses.replace(
        r_configs.TPU_DEFAULT, support_threshold=3, capacity=100_000,
        evict="lru"))
    assert (host.support_threshold, host.capacity, host.evict) == (
        3, 100_000, "lru")
    for bad in (dict(fold_kernel="ref"), dict(emit_kernel="fused"),
                dict(expand_kernel="chain"), dict(impl="leapfrog")):
        with pytest.raises(ValueError):
            engine_config_from_reference(dataclasses.replace(
                r_configs.TPU_DEFAULT, **bad))


R_PRESETS = sorted(name for name, v in vars(r_configs).items()
                   if isinstance(v, r_configs.JoinEngineConfig))


@pytest.mark.parametrize("name", R_PRESETS)
def test_every_reference_preset_converts(name):
    """Every preset of the reference's ``configs/paper_clftj.py`` carries
    across: every field the port shares keeps its value, the kernel paths
    and ``impl`` are mapped, and the host CLFTJ's policy is the one the
    preset names."""
    rcfg = getattr(r_configs, name)
    cfg = engine_config_from_reference(rcfg)
    mapped = {"impl": {"bsearch": "bsearch", "pallas": "leapfrog"}}
    paths = {"auto": "fused", "pallas": "fused", "xla": "chain"}
    for knob in ("expand_kernel", "fold_kernel", "emit_kernel"):
        mapped[knob] = paths
    for f in dataclasses.fields(rcfg):
        want = getattr(rcfg, f.name)
        assert getattr(cfg, f.name) == mapped.get(f.name, {}).get(
            want, want), f.name
    pol = cfg.host_policy()
    assert (pol.support_threshold, pol.capacity, pol.evict) == (
        rcfg.support_threshold, rcfg.capacity, rcfg.evict)
    port_name = name.replace("TPU_", "GPU_")
    assert getattr(t_configs, port_name) == cfg


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def _pass(entry):
    return np.concatenate(list(entry.engine.evaluate()), axis=0)


def test_plan_cache_iso_hit_bit_identical_to_reference(db, rdb):
    q = path_query(3)
    pc, rpc = PlanCache(db, CFG, max_plans=8, device="cpu"), RPlanCache(
        rdb, R_CFG, max_plans=8)
    e1, hit1, pos1 = pc.lookup(_port(q))
    r1, rhit1, rpos1 = rpc.lookup(q)
    assert not hit1 and not rhit1 and pos1 == rpos1
    assert (e1.order, e1.td.bags, e1.td.parent) == (
        r1.order, r1.td.bags, r1.td.parent)
    with enable_x64():
        r_cold = _pass(r1)
    cold = _pass(e1)
    np.testing.assert_array_equal(cold, r_cold)
    s = _scramble(q, 5)
    e2, hit2, _ = pc.lookup(_port(s))
    r2, rhit2, _ = rpc.lookup(s)
    assert hit2 and rhit2 and e2 is e1 and len(pc) == 1
    with enable_x64():
        r_warm = _pass(r2)
    warm = _pass(e2)
    np.testing.assert_array_equal(warm, r_warm)
    np.testing.assert_array_equal(warm, cold)
    assert e2.engine.stats["tier2_replay_hits"] == r2.engine.stats[
        "tier2_replay_hits"] > 0
    assert e1.engine.count() == len(cold)


@pytest.mark.parametrize("max_plans", [1, 0])
def test_plan_cache_lru_and_cold_regime_like_reference(db, rdb, max_plans):
    pc = PlanCache(db, CFG, max_plans=max_plans, device="cpu")
    rpc = RPlanCache(rdb, R_CFG, max_plans=max_plans)
    seq = [path_query(2), cycle_query(3), path_query(2), path_query(2)]
    hits = [pc.lookup(_port(q))[1] for q in seq]
    assert hits == [rpc.lookup(q)[1] for q in seq]
    assert hits == ([False, False, False, True] if max_plans else
                    [False] * 4)
    assert len(pc) == len(rpc) == max_plans
    assert pc.stats() == rpc.stats()


def test_config_keys_separate_plans(db):
    other = dataclasses.replace(CFG, cache_slots=CFG.cache_slots * 2)
    chain = dataclasses.replace(CFG, impl="leapfrog", expand_kernel="chain")
    keys = {config_key(c) for c in (CFG, other, chain)}
    assert len(keys) == 3
    q = _port(path_query(3))
    td, order = r_choose_plan(path_query(3), db.stats())
    pc = PlanCache(db, CFG, max_plans=8, device="cpu")
    _, hit_a, _ = pc.lookup(q)
    _, hit_b, _ = pc.lookup(q, TreeDecomposition(list(td.bags),
                                                 list(td.parent)), order)
    assert not hit_a and not hit_b and len(pc) == 2


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def test_concurrent_sessions_match_reference_oracle(db, rdb):
    base = [path_query(3), cycle_query(3), path_query(4)]
    rng = np.random.default_rng(99)
    work = [_scramble(base[min(int(rng.zipf(1.8)) - 1, len(base) - 1)],
                      1000 + i) for i in range(12)]
    oracle = {}
    for q in work:
        if q not in oracle:
            oracle[q] = _oracle(q, rdb)
    failures = []
    with _server(db, max_sessions=3, max_plans=8, block_queue=4) as srv:
        def client(tid, queries):
            for q in queries:
                while True:
                    try:
                        sess = srv.submit(_port(q), "stream")
                        break
                    except SessionRejected as e:
                        threading.Event().wait(min(e.retry_after_s, 0.05))
                blocks = list(sess.blocks())
                res = sess.result(timeout=120)
                if _rows(res.order, blocks) != oracle[q]:
                    failures.append((tid, q))
                r = sess.op_runs
                budget = (3 * r.get("expand", 0) + r.get("fold", 0)
                          + r.get("span", 0) + r.get("emit", 0) + 10)
                if sess.sync.count > budget:
                    failures.append((tid, "sync", sess.sync.count, budget))

        threads = [threading.Thread(target=client, args=(t, work[t::4]))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not failures, failures[:3]
        stats = srv.stats()
    assert stats["in_flight_high_water"] <= 3
    assert stats["completed"] == len(work) and stats["failed"] == 0
    assert stats["plan_cache"]["hits"] >= len(work) - len(base)


def test_admission_rejection_and_recovery(db, rdb):
    want = r_engine.count(path_query(3), rdb).count
    with _server(db, max_sessions=2, max_plans=4) as srv:
        srv.count(_port(path_query(3)))
        # hold the worker at the execution gate: both admitted sessions
        # stay in flight
        srv._exec_lock.acquire()
        try:
            s1 = srv.submit(_port(path_query(3)), "stream")
            s2 = srv.submit(_port(path_query(3)), "stream")
            with pytest.raises(SessionRejected) as exc:
                srv.submit(_port(path_query(3)), "stream")
            assert exc.value.retry_after_s > 0
            assert srv.stats()["rejected"] == 1
            s2.cancel()
        finally:
            srv._exec_lock.release()
        rows = sum(b.shape[0] for b in s1.blocks())
        assert rows == s1.result(timeout=120).count == want
        with pytest.raises(Exception):
            s2.result(timeout=120)
        assert srv.count(_port(path_query(3))).count == want
        assert srv.stats()["in_flight"] == 0


def test_worker_syncs_stay_out_of_client_counter(db):
    with _server(db, max_sessions=2) as srv:
        with SyncCounter() as sc:
            res = srv.evaluate(_port(path_query(3)))
        assert sc.count == 0 and sc.async_count == 0
        assert res.count > 0


def test_session_result_order_uses_client_names(db, rdb):
    q = RCQ((RAtom("E", ("b", "q")), RAtom("E", ("z", "b")),
             RAtom("E", ("a", "z"))))
    with _server(db) as srv:
        res = srv.evaluate(_port(q))
        assert set(res.order) == {"a", "b", "q", "z"}
        assert _rows(res.order, [res.tuples]) == _oracle(q, rdb)
        assert not res.plan_cache_hit
        s = _scramble(q, 3)
        res2 = srv.evaluate(_port(s))
        assert res2.plan_cache_hit
        assert _rows(res2.order, [res2.tuples]) == _oracle(s, rdb)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

_WRITER = r"""
import dataclasses
from repro_torch.configs.paper_clftj import GPU_SERVE
from repro_torch.core import path_query
from repro_torch.core.db import graph_db
from repro_torch.core.engine import serve
from repro_torch.data.graphs import zipf_graph

CFG = dataclasses.replace(GPU_SERVE, cache_slots=512, cache_assoc=4,
                          payload_rows=1 << 13, frontier_capacity=1 << 14)
db = graph_db(zipf_graph(16, 110, 1.1, seed=314))
with serve(db, CFG, device="cpu") as srv:
    r = srv.evaluate(path_query(3))
    assert r.tuples is not None and len(r.tuples) > 0
    srv.save_snapshot({snap!r})
print("WROTE")
"""


def test_snapshot_from_other_process_serves_warm(db, rdb, tmp_path):
    snap = str(tmp_path / "serve_snap.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _WRITER.format(snap=snap)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "WROTE" in proc.stdout
    with _server(db) as srv:
        summary = srv.load_snapshot(snap)
        assert summary == {"status": "ok", "plans": 1, "tables": 1,
                           "flushed": 0, "skipped": 0}
        s = _scramble(path_query(3), 11)
        res = srv.evaluate(_port(s))
        assert res.plan_cache_hit and res.tier2_replay_hits > 0
        assert _rows(res.order, [res.tuples]) == _oracle(s, rdb)


@pytest.fixture(scope="module")
def warm_snapshot(db, tmp_path_factory):
    """An in-process snapshot with resident payload blocks."""
    snap = str(tmp_path_factory.mktemp("serve") / "warm.npz")
    with _server(db) as srv:
        srv.evaluate(_port(path_query(3)))
        srv.evaluate(_port(cycle_query(3)))
        srv.save_snapshot(snap)
    return snap


def test_snapshot_roundtrip_in_process(db, rdb, warm_snapshot):
    with _server(db) as srv:
        summary = srv.load_snapshot(warm_snapshot)
        assert summary["status"] == "ok"
        assert summary["plans"] == 2 and summary["flushed"] == 0
        res = srv.evaluate(_port(path_query(3)))
        assert res.plan_cache_hit and res.tier2_replay_hits > 0
        assert _rows(res.order, [res.tuples]) == _oracle(path_query(3), rdb)


@pytest.mark.parametrize("mangle", ["truncate", "garbage", "version"])
def test_unusable_snapshot_falls_back_cold(db, rdb, warm_snapshot, tmp_path,
                                           mangle):
    bad = str(tmp_path / f"bad_{mangle}.npz")
    raw = open(warm_snapshot, "rb").read()
    if mangle == "truncate":
        open(bad, "wb").write(raw[: len(raw) // 3])
    elif mangle == "garbage":
        open(bad, "wb").write(b"\x00\xde\xad\xbe\xef" * 64)
    else:
        man = {"version": 99, "cfg_key": "", "plans": []}
        arr = np.frombuffer(json.dumps(man).encode(), np.uint8).copy()
        np.savez_compressed(bad, manifest=arr)
    with _server(db) as srv:
        with pytest.warns(UserWarning):
            summary = srv.load_snapshot(bad)
        assert summary["status"] == "cold" and summary["plans"] == 0
        res = srv.evaluate(_port(path_query(3)))
        assert not res.plan_cache_hit
        assert _rows(res.order, [res.tuples]) == _oracle(path_query(3), rdb)


def test_config_mismatch_starts_cold(db, rdb, warm_snapshot):
    other = dataclasses.replace(CFG, cache_slots=256)
    with _server(db, other) as srv:
        summary = srv.load_snapshot(warm_snapshot)
        assert summary["status"] == "config-mismatch"
        assert summary["plans"] == 0 and len(srv.plan_cache) == 0
        res = srv.count(_port(path_query(3)))
        assert res.count == r_engine.count(path_query(3), rdb).count


# ---------------------------------------------------------------------------
# slab epoch and table states
# ---------------------------------------------------------------------------

def _resident_payload_state(pc):
    """(entry, node, state) for a table with resident payload blocks."""
    for entry in pc.entries():
        for node, st in entry.engine.cache.export_state().items():
            if (st["used"] & (st["pay_len"] >= 0)).any():
                return entry, node, st
    raise AssertionError("no table with resident payload blocks")


def test_stale_slab_epoch_flushes_payload_only(db):
    pc = PlanCache(db, CFG, max_plans=4, device="cpu")
    entry, _, _ = pc.lookup(_port(path_query(3)))
    ref = _pass(entry)
    entry, node, st = _resident_payload_state(pc)
    tbl = entry.engine.cache.get(node)
    flushes0 = tbl.payload_flushes
    keys0 = tbl.keys.clone()
    bad = dict(st, slab_bump=0)   # the epoch lost, blocks still claimed
    assert tbl.import_state(bad) == "flushed"
    assert tbl.payload_flushes == flushes0 + 1 and tbl.slab_bump == 0
    assert int(tbl.pay_len.max()) == -1 and tbl.slab is None
    assert torch.equal(tbl.keys, keys0)
    np.testing.assert_array_equal(_pass(entry), ref)


def test_block_past_epoch_also_flushes(db, rdb):
    pc = PlanCache(db, CFG, max_plans=4, device="cpu")
    e0, _, _ = pc.lookup(_port(path_query(3)))
    _pass(e0)
    entry, node, st = _resident_payload_state(pc)
    tbl = entry.engine.cache.get(node)
    off, ln = st["pay_off"].copy(), st["pay_len"].copy()
    r, w = np.argwhere(st["used"] & (ln >= 0))[0]
    off[r, w], ln[r, w] = st["slab_bump"], 4
    assert tbl.import_state(dict(st, pay_off=off, pay_len=ln)) == "flushed"
    canon = RCQ(tuple(RAtom(a.relation, a.vars) for a in entry.cq.atoms))
    assert _rows(entry.order, [_pass(entry)]) == _oracle(canon, rdb)


def test_rejected_import_leaves_table_unchanged(db):
    pc = PlanCache(db, CFG, max_plans=4, device="cpu")
    entry, _, _ = pc.lookup(_port(path_query(3)))
    entry.engine.count()
    node, st = next(iter(entry.engine.cache.export_state().items()))
    tbl = entry.engine.cache.get(node)
    before = {k: getattr(tbl, k).clone() for k in ("keys", "vals", "used",
                                                   "stamp", "cost")}
    assert tbl.import_state(dict(st, keys=np.zeros((3, 3), np.int64))) \
        == "rejected"
    assert tbl.import_state({"vals": st["vals"]}) == "rejected"
    for k, v in before.items():
        assert torch.equal(getattr(tbl, k), v), k


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for node in a:
        assert set(a[node]) == set(b[node]), node
        for k in a[node]:
            np.testing.assert_array_equal(np.asarray(a[node][k]),
                                          np.asarray(b[node][k]),
                                          err_msg=f"node {node} {k}")


def test_export_state_equals_reference_and_carries_both_ways(db, rdb):
    q = cycle_query(4)
    pc, rpc = PlanCache(db, CFG, max_plans=4, device="cpu"), RPlanCache(
        rdb, R_CFG, max_plans=4)
    entry, _, _ = pc.lookup(_port(q))
    rentry, _, _ = rpc.lookup(q)
    for _ in range(2):  # cold, then warm: replay hits and more stores
        _pass(entry)
        with enable_x64():
            _pass(rentry)
    states = entry.engine.cache.export_state()
    with enable_x64():
        r_states = rentry.engine.cache.export_state()
    _assert_states_equal(states, r_states)
    assert any(st["slab_bump"] > 0 for st in states.values())
    tcfg = CFG.cache_config()
    rcfg = R_CFG.cache_config()
    for node, st in r_states.items():
        # reference -> port, then port -> reference
        tbl = table_from_reference(st, tcfg, device="cpu")
        back = tbl.export_state()
        _assert_states_equal({node: back}, {node: st})
        with enable_x64():
            rtbl = RDeviceCache.create(rcfg)
            assert rtbl.import_state(back) == "ok"
            _assert_states_equal({node: rtbl.export_state()}, {node: st})
    with pytest.raises(ValueError):
        table_from_reference(next(iter(r_states.values())),
                             dataclasses.replace(tcfg, assoc=2),
                             device="cpu")
