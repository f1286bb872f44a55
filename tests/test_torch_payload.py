"""Payload-replay evaluation of the port (``CacheConfig(cache_payloads=
True)``, on the CPU) against the JAX reference (``backend="jax"``, its
default CPU FOLD path) on the same database and plan:

* cold and warm passes on one shared engine: tuples in block order,
  ``tier2_replay_hits``, the payload counters (flushes, skips, throttled
  folds, slab rows), the other tier-2 counters, and the ``device_get``
  syncs label by label — on the 4-cycle and the bowtie, dedup on and off,
  with the store throttle engaged, and with a 64-row arena whose epoch
  flush lands in the middle of a fold;
* the table ops one by one on seeded inputs: ``_probe_payload``,
  ``_insert`` carrying the payload planes, ``alloc_blocks`` with its
  flush, and ``_rehash`` keeping the slab;
* a warm start from the reference's exported tables
  (``convert.table_from_reference``);
* the plain splice against the reference's ``splice_step`` and its
  fused Pallas kernel in interpret mode.

Everything compared is an integer, so the tolerance is none: equal bit
for bit (past the valid prefix, rows are unconstrained but invalid)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.core import cache as rc
from repro.core import engine as r_engine
from repro.core.cached_frontier import JaxCachedTrieJoin
from repro.core.cq import bowtie_query, cycle_query
from repro.core.db import graph_db
from repro.core.frontier import Frontier as RFrontier
from repro.core.hostsync import SyncCounter as RSyncCounter
from repro.kernels.fold import FusedFoldConfig
from repro.kernels.fold import fused as r_fold_fused, xla as r_fold_xla
from repro_torch.convert import from_reference, table_from_reference
from repro_torch.core import cache as tc
from repro_torch.core import schedule as t_schedule
from repro_torch.core.cached_frontier import CachedTrieJoin
from repro_torch.core.frontier import Frontier as TFrontier
from repro_torch.core.hostsync import SyncCounter as TSyncCounter
from repro_torch.kernels.fold import plain as t_fold

CAP = 1 << 8
QUERIES = {"cycle-4": cycle_query(4), "bowtie": bowtie_query()}
PAY = dict(policy="setassoc", slots=64, assoc=4, cache_payloads=True,
           payload_rows=1 << 12)
STATS = ["tier1_rows_collapsed", "tier2_replay_hits"] + [
    f"tier2_{k}" for k in ("hits", "misses", "probes", "inserts",
                           "evictions", "resizes", "payload_flushes",
                           "payload_skips", "payload_throttled",
                           "slab_rows")]
FIELDS = ("assign", "factor", "orig", "lo", "hi")


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    return graph_db(rng.integers(0, 12, size=(80, 2)))


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


def _engines(qname, db, dedup, cfg):
    q, td, order, tdb, tq, ttd, tord = _plan(qname, db)
    ref = JaxCachedTrieJoin(q, td, order, db, capacity=CAP, dedup=dedup,
                            cache=rc.CacheConfig(**cfg))
    port = CachedTrieJoin(tq, ttd, tord, tdb, capacity=CAP, dedup=dedup,
                          cache=tc.CacheConfig(**cfg), device="cpu")
    return ref, port


def _same_pass(ref, port, what):
    """One evaluate pass of each engine: same blocks in the same order,
    same counters, same syncs label by label; returns the port's rows."""
    with RSyncCounter() as rs:
        rb = [np.asarray(b) for b in ref.evaluate()]
    with TSyncCounter() as ts:
        tb = list(port.evaluate())
    assert len(tb) == len(rb) > 0, what
    for i, (a, b) in enumerate(zip(tb, rb)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: block {i}")
    for k in STATS:
        assert port.stats[k] == ref.stats[k], f"{what}: {k}"
    assert ts.count == rs.count, (what, ts.events, rs.events)
    assert ts.label_counts == rs.label_counts, what
    return np.concatenate(tb)


CASES = [pytest.param(qn, dedup, {}, id=f"{qn}-{'dedup' if dedup else 'nodedup'}")
         for qn in QUERIES for dedup in (True, False)] + [
    # the store throttle engages (and probation stores every 2nd fold)
    pytest.param("cycle-4", True, dict(payload_throttle_probes=32,
                                       payload_throttle_hit_rate=0.9,
                                       payload_probation=2),
                 id="cycle-4-throttled"),
]


@pytest.mark.parametrize("qname,dedup,extra", CASES)
def test_payload_evaluate_cold_and_warm_match_reference(db, qname, dedup,
                                                        extra):
    ref, port = _engines(qname, db, dedup, {**PAY, **extra})
    cold = _same_pass(ref, port, "cold")
    warm = _same_pass(ref, port, "warm")
    np.testing.assert_array_equal(np.sort(cold, axis=0),
                                  np.sort(warm, axis=0))
    assert port.stats["tier2_replay_hits"] > 0
    assert port.stats["fold_splice_calls_torch"] > 0
    assert port.stats["fold_splice_calls_cuda"] == 0
    if extra:
        assert port.stats["tier2_payload_throttled"] > 0


def test_tiny_arena_flushes_mid_fold_like_reference(db, monkeypatch):
    """A 64-row arena: the epoch flush fires while a fold is storing the
    blocks of several exit chunks, so blocks admitted from earlier chunks
    of that fold are dropped; the port must flush, drop and store exactly
    as the reference does."""
    seen = {"admitted": 0, "mid_fold": 0}
    insert = t_schedule.ScheduleExecutor._insert_payload_blocks
    alloc = tc.DeviceCache.alloc_blocks

    def spy_insert(self, *a, **kw):
        seen["admitted"] = 0
        return insert(self, *a, **kw)

    def spy_alloc(self, lens, active):
        flushes = self.payload_flushes
        offs, admit = alloc(self, lens, active)
        if self.payload_flushes > flushes and seen["admitted"]:
            seen["mid_fold"] += 1
        seen["admitted"] += int(admit.any())
        return offs, admit

    monkeypatch.setattr(t_schedule.ScheduleExecutor,
                        "_insert_payload_blocks", spy_insert)
    monkeypatch.setattr(tc.DeviceCache, "alloc_blocks", spy_alloc)
    ref, port = _engines("cycle-4", db, True, {**PAY, "payload_rows": 64})
    _same_pass(ref, port, "cold")
    _same_pass(ref, port, "warm")
    assert port.stats["tier2_payload_flushes"] > 0
    assert seen["mid_fold"] > 0, "no flush landed in the middle of a fold"
    assert port.stats["tier2_replay_hits"] > 0


def test_warm_start_from_reference_tables_splices_like_reference(db):
    """Warm the reference, carry its exported tables across with
    ``table_from_reference``: the port's warm pass splices exactly as a
    reference engine that imported the same tables."""
    q, td, order, tdb, tq, ttd, tord = _plan("bowtie", db)
    cold = JaxCachedTrieJoin(q, td, order, db, capacity=CAP,
                             cache=rc.CacheConfig(**PAY))
    list(cold.evaluate())
    states = cold.cache.export_state()
    assert states and all("slab" in s for s in states.values())
    ref, port = _engines("bowtie", db, True, PAY)
    with enable_x64():
        assert set(ref.cache.import_state(states).values()) == {"ok"}
    cfg = tc.CacheConfig(**PAY)
    for v, st in states.items():
        port.cache.tables[v] = table_from_reference(st, cfg, device="cpu")
        tbl = port.cache.tables[v]
        np.testing.assert_array_equal(tbl.slab.numpy(), st["slab"])
        assert tbl.slab_bump == st["slab_bump"] > 0
    _same_pass(ref, port, "warm from reference tables")
    assert port.stats["tier2_replay_hits"] > 0
    with pytest.raises(ValueError):
        table_from_reference(states[next(iter(states))],
                             tc.CacheConfig(**{**PAY, "assoc": 2}),
                             device="cpu")


# ---------------------------------------------------------------------------
# Table ops, one by one
# ---------------------------------------------------------------------------

def _pay_table(ways, sets):
    z = lambda dt: np.zeros((sets, ways), dt)  # noqa: E731
    return [z(np.int64), z(np.int64), z(bool), z(np.int32), z(np.int64),
            z(np.int32), np.full((sets, ways), -1, np.int32)]


@pytest.mark.parametrize("policy,ways,sets", [("direct", 1, 16),
                                              ("setassoc", 4, 8),
                                              ("costaware", 4, 8)])
def test_payload_insert_and_probe_match_reference(policy, ways, sets):
    """Batches mixing payload-bearing and count-only candidates over a
    small key range (in-batch duplicates; payload candidates refreshing
    count-only residents in place): the same planes, admit and evict
    counts after every insert, and the same probe results."""
    C = 96
    rng = np.random.default_rng(ways * 7 + sets)
    r_tab = _pay_table(ways, sets)
    t_tab = [torch.from_numpy(a.copy()) for a in r_tab]
    names = ("keys", "vals", "used", "stamp", "cost", "pay_off", "pay_len")
    refreshed = 0
    for step in range(8):
        keys = rng.integers(-30, 30, size=C).astype(np.int64)
        keys[rng.random(C) < 0.2] = keys[0]
        vals = rng.integers(0, 50, size=C).astype(np.int64)
        costs = np.maximum(vals, 1)
        active = rng.random(C) < 0.7
        with_pay = step % 2 == 1 or rng.random() < 0.3
        poff = rng.integers(0, 1000, size=C).astype(np.int32)
        plen = np.where(rng.random(C) < (0.8 if with_pay else 0.0),
                        rng.integers(0, 9, size=C), -1).astype(np.int32)
        tick = 2 * step + 1
        before = r_tab[6].copy()
        with enable_x64():
            out = rc._insert(*map(jnp.asarray, r_tab[:5]),
                             jnp.asarray(keys), jnp.asarray(vals),
                             jnp.asarray(costs), jnp.asarray(active),
                             jnp.int32(tick), policy=policy,
                             rounds=min(ways, 8),
                             pay=tuple(map(jnp.asarray, (r_tab[5], r_tab[6],
                                                         poff, plen))))
            r_tab = [np.asarray(a) for a in out[:7]]
            r_counts = (int(out[7]), int(out[8]))
        out_t = tc._insert(*t_tab[:5], torch.from_numpy(keys),
                           torch.from_numpy(vals), torch.from_numpy(costs),
                           torch.from_numpy(active), tick, policy=policy,
                           rounds=min(ways, 8),
                           pay=(t_tab[5], t_tab[6], torch.from_numpy(poff),
                                torch.from_numpy(plen)))
        t_tab = list(out_t[:7])
        assert (int(out_t[7]), int(out_t[8])) == r_counts, step
        for name, a, b in zip(names, t_tab, r_tab):
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"step {step}: {name}")
        refreshed += int(((before < 0) & (r_tab[6] >= 0)
                          & (r_tab[3] == tick)).sum())
        qkeys = np.concatenate([keys[: C // 2], keys[C // 2:] + 1])
        qactive = np.roll(active, 5)
        with enable_x64():
            r_out = rc._probe_payload(
                *map(jnp.asarray, (r_tab[0], r_tab[2], r_tab[3], r_tab[5],
                                   r_tab[6], qkeys, qactive)),
                jnp.int32(tick + 1))
        t_out = tc._probe_payload(
            t_tab[0], t_tab[2], t_tab[3], t_tab[5], t_tab[6],
            torch.from_numpy(qkeys), torch.from_numpy(qactive), tick + 1)
        for name, a, b in zip(("hit", "poff", "plen", "stamp"), t_out,
                              r_out):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"step {step}: {name}")
        r_tab[3] = np.asarray(r_out[3])
        t_tab[3] = t_out[3]
    assert refreshed > 0, "no payload-less resident was refreshed"


def test_alloc_blocks_and_flush_match_reference():
    """Bump allocation over a 50-row arena: refusals of blocks larger than
    the arena, prefix-wise refusals, and epoch flushes that invalidate
    every payload pointer."""
    kw = dict(policy="setassoc", slots=16, assoc=4, cache_payloads=True,
              payload_rows=50)
    with enable_x64():
        r = rc.DeviceCache.create(rc.CacheConfig(**kw))
    t = tc.DeviceCache.create(tc.CacheConfig(**kw), device="cpu")
    rng = np.random.default_rng(4)
    t.pay_len = torch.zeros_like(t.pay_len)
    r.pay_len = jnp.zeros_like(r.pay_len)
    for step in range(12):
        lens = rng.integers(0, 24 if step != 5 else 80, size=6)
        active = rng.random(6) < 0.8
        ro, ra = r.alloc_blocks(lens, active)
        to, ta = t.alloc_blocks(lens, active)
        np.testing.assert_array_equal(to, ro, err_msg=f"step {step}")
        np.testing.assert_array_equal(ta, ra, err_msg=f"step {step}")
        assert to.dtype == np.int32 and ta.dtype == bool
        assert (t.slab_bump, t.payload_flushes) == (r.slab_bump,
                                                    r.payload_flushes)
        np.testing.assert_array_equal(t.pay_len.numpy(),
                                      np.asarray(r.pay_len))
    assert t.payload_flushes > 1


def test_rehash_keeps_slab_like_reference():
    """A dynamic payload table that resizes: the metadata planes ride the
    rehash, and the slab and its bump pointer survive untouched."""
    kw = dict(policy="setassoc", slots=16, assoc=4, dynamic=True,
              resize_interval=2, min_slots=4, max_slots=1 << 10,
              cache_payloads=True, payload_rows=256)
    with enable_x64():
        r = rc.DeviceCache.create(rc.CacheConfig(**kw))
    t = tc.DeviceCache.create(tc.CacheConfig(**kw), device="cpu")
    r.ensure_slab(3)
    t.ensure_slab(3)
    rng = np.random.default_rng(9)
    slab = rng.integers(0, 99, size=(257, 3)).astype(np.int32)
    r.slab = jnp.asarray(slab)
    t.slab.copy_(torch.from_numpy(slab))
    slab_obj = t.slab
    resized = 0
    for step in range(3):
        keys = rng.integers(0, 1000, size=48).astype(np.int64)
        vals = rng.integers(1, 9, size=48).astype(np.int64)
        active = rng.random(48) < 0.8
        lens, admit = r.alloc_blocks(vals, active)
        offs_t, admit_t = t.alloc_blocks(vals, active)
        np.testing.assert_array_equal(offs_t, lens)
        plen = np.where(admit, vals, -1).astype(np.int32)
        with enable_x64():
            r.probe_payload(jnp.asarray(keys), jnp.asarray(active))
            r.insert(jnp.asarray(keys), jnp.asarray(vals),
                     jnp.asarray(admit), poff=jnp.asarray(lens),
                     plen=jnp.asarray(plen))
            r_delta = r.maybe_resize()
        t.probe_payload(torch.from_numpy(keys), torch.from_numpy(active))
        t.insert(torch.from_numpy(keys), torch.from_numpy(vals),
                 torch.from_numpy(admit), poff=torch.from_numpy(offs_t),
                 plen=torch.from_numpy(plen))
        delta = t.maybe_resize()
        assert delta == r_delta, step
        resized += delta != 0
        for name in ("keys", "vals", "used", "stamp", "cost", "pay_off",
                     "pay_len"):
            np.testing.assert_array_equal(
                getattr(t, name).numpy(), np.asarray(getattr(r, name)),
                err_msg=f"step {step}: {name}")
        assert t.slab is slab_obj and t.slab_bump == r.slab_bump
    np.testing.assert_array_equal(t.slab.numpy(), slab)
    rs, ts = r.stats(), t.stats()
    for k in ("hits", "misses", "probes", "inserts", "evictions", "resizes",
              "slots", "occupancy", "payload_hits", "payload_flushes",
              "slab_rows"):
        assert ts[k] == rs[k], k
    assert resized > 0


# ---------------------------------------------------------------------------
# The plain splice against the reference's
# ---------------------------------------------------------------------------

def _splice_inputs(C, seed, n=5, m=3, w=3, slab_rows=600, big=False):
    """A parent chunk, payload hits with contiguous blocks in a slab whose
    last row is scratch, as the executor hands them to FOLD."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 9, size=(C, m)).astype(np.int32)
    P = RFrontier(rng.integers(0, 40, size=(C, n)).astype(np.int32),
                  rng.integers(1, 5, size=(C,)).astype(np.int64),
                  np.arange(C) < C // 2,
                  np.sort(rng.integers(0, C, size=C)).astype(np.int32), lo,
                  lo + rng.integers(0, 4, size=(C, m)).astype(np.int32))
    hit = (np.arange(C) < C // 2) & (rng.random(C) < (0.9 if big else 0.3))
    plen = np.where(hit, rng.integers(1, 12 if big else 6, size=C),
                    0).astype(np.int32)
    starts = rng.integers(0, slab_rows - 12, size=C)
    poff = np.where(hit, starts, 0).astype(np.int32)
    slab = rng.integers(0, 1 << 20, size=(slab_rows + 1, w)).astype(np.int32)
    return P, hit, poff, plen, slab


@pytest.mark.parametrize("seed,big", [(0, False), (1, False), (2, True)],
                         ids=["seed0", "seed1", "over-capacity"])
def test_plain_splice_matches_reference(seed, big):
    C, d0, d1 = 1 << 8, 1, 3
    P, hit, poff, plen, slab = _splice_inputs(C, seed, big=big)
    with enable_x64():
        args = (RFrontier(*(jnp.asarray(x) for x in P)), jnp.asarray(hit),
                jnp.asarray(poff), jnp.asarray(plen), jnp.asarray(slab))
        Fx, sx = r_fold_xla.build(d0=d0, d1=d1, with_replay=False,
                                  with_splice=True)(*args)
        Fp, sp = r_fold_fused.build(
            d0=d0, d1=d1, with_replay=False, with_splice=True,
            config=FusedFoldConfig(interpret=True))(*args)
    Ft, st = t_fold.splice(TFrontier(*(torch.from_numpy(np.array(x))
                                       for x in P)),
                           torch.from_numpy(hit), torch.from_numpy(poff),
                           torch.from_numpy(plen), torch.from_numpy(slab),
                           d0=d0, d1=d1)
    assert st.dtype == torch.int64
    n_spl = int(plen[hit].sum())
    np.testing.assert_array_equal(st.numpy(), [0, n_spl, min(n_spl, C)])
    np.testing.assert_array_equal(st.numpy(), np.asarray(sx))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sp))
    k = min(n_spl, C)
    for other, name in ((Fx, "xla"), (Fp, "pallas")):
        np.testing.assert_array_equal(Ft.valid.numpy(),
                                      np.asarray(other.valid), err_msg=name)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(Ft, f)[:k].numpy(), np.asarray(getattr(other, f))[:k],
                err_msg=f"{name}: {f}")
    if big:
        assert n_spl > C, "case must overflow the chunk"


def test_fold_registry_arities():
    """The registry builds the splice-only and merged arities, checks the
    plain path's inputs, and the merged arity appends the splice rows
    after the replay rows."""
    from repro_torch.kernels import registry
    C = 1 << 8
    spec = registry.FoldSpec(capacity=C, n_vars=5, n_atoms=3)
    fn = registry.fold_fn(spec, d0=1, d1=3, with_replay=False,
                          with_splice=True)
    P, hit, poff, plen, slab = _splice_inputs(C, 0)
    args = [TFrontier(*(torch.from_numpy(np.array(x)) for x in P)),
            torch.from_numpy(hit), torch.from_numpy(poff),
            torch.from_numpy(plen), torch.from_numpy(slab)]
    F, stats = fn(*args)
    assert int(stats[1]) == int(plen[hit].sum())
    with pytest.raises(ValueError):
        fn(*args[:4], args[4][:, :2])  # slab narrower than [d0, d1]
    both = registry.fold_fn(spec, d0=1, d1=3, with_replay=True,
                            with_splice=True)
    P0 = args[0]
    active = P0.valid & ~args[1]
    ror = torch.arange(C, dtype=torch.int32)
    E = P0._replace(orig=ror)  # exit row i is representative i's only one
    Fm, sm = both(P0, active, ror, E, *args[1:])
    n1 = int(active.sum())
    assert sm.tolist() == [n1, int(stats[1]), n1 + int(stats[2])]
    k = min(n1 + int(stats[2]), C)
    assert torch.equal(Fm.valid, torch.arange(C) < k)
    assert torch.equal(Fm.assign[n1:k], F.assign[:k - n1])
    with pytest.raises(ValueError):
        both(P0, active, ror, E, *args[1:4], args[4][:, :2])
