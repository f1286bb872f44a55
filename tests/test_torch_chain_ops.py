"""The port's FOLD and EMIT op chains (``kernels/fold/chain.py``,
``kernels/emit/chain.py``, the ``"chain"`` path of ``fold_kernel`` /
``emit_kernel``) against the reference's XLA chains and, engine by
engine, against the reference run with the mapped knobs (the port's
``"chain"`` is the reference's ``"xla"``, its ``"fused"`` the
reference's ``"pallas"``, interpret mode on the CPU):

* the three FOLD arities of ``fold/chain.py`` against
  ``repro.kernels.fold.xla.build`` on seeded chunks: the valid prefix and
  ``stats`` bit for bit, with sorted and unsorted exits, more pairs than
  the capacity, and a splice cut short; EMIT against
  ``repro.kernels.emit.xla.build``;
* ``engine.count`` / ``evaluate`` / ``evaluate_stream`` with each knob
  forced both ways: rows in block order, tier-1/tier-2 counters, and the
  launches per path;
* payload replay cold and warm on one shared engine: rows in block
  order, counters and every exported table plane;
* ``StaticCLFTJ`` count and evaluation cold and warm, on the bowtie and
  on the 5-path (whose nested TD folds a merged FOLD's unsorted output:
  the fused path sorts it first, the chain takes it as it comes): rows,
  stats and every table plane.

Everything compared is an integer, so the tolerance is none."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.core import cache as rc
from repro.core import engine as r_engine
from repro.core.cached_frontier import JaxCachedTrieJoin
from repro.core.cq import bowtie_query, path_query
from repro.core.db import graph_db
from repro.core.distributed import StaticCLFTJ as RStatic
from repro.data.graphs import zipf_graph
from repro.kernels.emit import xla as r_emit_xla
from repro.kernels.fold import xla as r_fold_xla
from repro_torch.convert import from_reference
from repro_torch.core import cache as tc
from repro_torch.core import engine as t_engine
from repro_torch.core.cached_frontier import CachedTrieJoin
from repro_torch.core.distributed import StaticCLFTJ as TStatic
from repro_torch.kernels import registry
from repro_torch.kernels.emit import chain as emit_chain
from test_torch_kernels import (_assert_chunks_equal, _merged_inputs,
                                _to_jax, _to_torch)
from test_torch_serving import _assert_states_equal
from test_torch_static import _same_eval_pass, _same_tables

# the port's kernel paths and the reference's names for them
REF_PATH = {"fused": "pallas", "chain": "xla"}
KNOBS = [("fused", "fused"), ("chain", "chain"), ("chain", "fused"),
         ("fused", "chain")]
BOTH_WAYS = KNOBS[:2]
ARITIES = {"replay": (True, False), "splice": (False, True),
           "merged": (True, True)}
# C, seed, _fold_inputs kwargs, side (tests/test_torch_kernels.py)
OP_CASES = {
    "sorted": (1 << 8, 0, {}, "both"),
    "unsorted": (1 << 8, 8, {}, "unsorted"),
    "unsorted-4096": (1 << 12, 3, {}, "unsorted"),
    # more replay pairs than the capacity: truncated, needed uncapped
    "overflow": (1 << 8, 4, dict(n_parents=200, n_exits=250, n_reps=4),
                 "both"),
    # the replay fits, replay + splice does not
    "splice-truncated": (1 << 8, 5, dict(n_parents=120, n_exits=200,
                                         n_reps=40), "both"),
}
STATS = ["tier1_rows_collapsed", "tier2_replay_hits"] + [
    f"tier2_{k}" for k in ("hits", "misses", "probes", "inserts",
                           "evictions", "payload_flushes", "payload_skips",
                           "slab_rows")]
PAY = dict(policy="setassoc", slots=64, assoc=4, cache_payloads=True,
           payload_rows=1 << 12)
STATIC_PAY = dict(policy="setassoc", slots=256, assoc=4,
                  cache_payloads=True, payload_rows=1 << 13)


def _arity_args(arity, inputs):
    P, active, ror, E, hit, poff, plen, slab = inputs
    replay, splice = ARITIES[arity]
    return ((P, active, ror, E) if replay else (P,)) + (
        (hit, poff, plen, slab) if splice else ())


@pytest.mark.parametrize("case", list(OP_CASES))
@pytest.mark.parametrize("arity", list(ARITIES))
def test_fold_chain_matches_reference_xla(arity, case):
    C, seed, kw, side = OP_CASES[case]
    d0, d1 = 1, 3
    inputs = _merged_inputs(C, seed, kw, side)
    replay, splice = ARITIES[arity]
    args = _arity_args(arity, inputs)
    with enable_x64():
        jargs = tuple(_to_jax(a) if isinstance(a, tuple) else jnp.asarray(a)
                      for a in args)
        Fx, sx = r_fold_xla.build(d0=d0, d1=d1, with_replay=replay,
                                  with_splice=splice)(*jargs)
    fn = registry.fold_fn(registry.FoldSpec(capacity=C, n_vars=5,
                                            n_atoms=3),
                          path="chain", d0=d0, d1=d1, with_replay=replay,
                          with_splice=splice)
    assert fn.path == "chain"
    Ft, st = fn(*(_to_torch(a) if isinstance(a, tuple)
                  else torch.from_numpy(a) for a in args))
    assert st.dtype == torch.int64 and st.shape == (3,)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sx))
    k = _assert_chunks_equal(Ft, Fx, f"{arity} {case}: chain vs xla")
    assert k == min(int(st[2]), C)
    if case == "overflow" and replay:
        assert int(st[0]) > C, "case must overflow the chunk"
    if case == "splice-truncated" and arity == "merged":
        assert int(st[2]) > C, "case must overflow the chunk"


@pytest.mark.parametrize("C,density,seed", [(1 << 8, 0.0, 0),
                                            (1 << 8, 0.3, 1),
                                            (1 << 10, 1.0, 2),
                                            (1 << 12, 0.5, 3)])
def test_emit_chain_matches_reference_xla(C, density, seed):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, 1 << 20, size=(C, 4)).astype(np.int32)
    valid = rng.random(C) < density
    px, kx = r_emit_xla.build()(jnp.asarray(assign), jnp.asarray(valid))
    fn = registry.emit_fn(registry.EmitSpec(capacity=C, n_vars=4),
                          path="chain")
    pt, kt = fn(torch.from_numpy(assign), torch.from_numpy(valid))
    assert fn.path == "chain" and kt.dtype == torch.int32
    assert int(kt) == int(kx) == int(valid.sum())
    np.testing.assert_array_equal(pt[:int(kt)].numpy(),
                                  np.asarray(px)[:int(kx)])
    pc, kc = emit_chain.pack(torch.from_numpy(assign),
                             torch.from_numpy(valid))
    assert torch.equal(pc[:int(kc)], pt[:int(kt)])


def test_registry_refuses_unknown_paths():
    spec = registry.FoldSpec(capacity=8, n_vars=3, n_atoms=2)
    for bad in ("xla", "auto", "pallas"):
        with pytest.raises(ValueError, match="path"):
            registry.fold_fn(spec, path=bad, d0=0, d1=1)
        with pytest.raises(ValueError, match="path"):
            registry.emit_fn(registry.EmitSpec(capacity=8, n_vars=3),
                             path=bad)
    with pytest.raises(ValueError, match="fold_kernel"):
        t_engine.evaluate(bowtie_query(), graph_db(np.zeros((1, 2), int)),
                          device="cpu", fold_kernel="xla")


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    return graph_db(rng.integers(0, 12, size=(80, 2)))


@pytest.fixture(scope="module")
def zdb():
    return graph_db(zipf_graph(16, 110, 1.1, seed=314))


def _plan(q, db):
    td, order = r_engine.plan_query(q, db)
    return (td, order) + from_reference(
        db.relations, [(a.relation, a.vars) for a in q.atoms], td.bags,
        td.parent, order, td.children)


def _launch_key(op, path):
    return f"{op}_calls_{'chain' if path == 'chain' else 'torch'}"


def _assert_paths(counters, fold, emit, what):
    """Every FOLD and EMIT launch went down the knob's path."""
    for op, path in (("fold", fold), ("emit", emit)):
        key = _launch_key(op, path)
        assert counters[key] > 0, (what, key)
        for p in ("cuda", "torch", "chain"):
            if f"{op}_calls_{p}" != key:
                assert counters.get(f"{op}_calls_{p}", 0) == 0, (what, p)


@pytest.mark.parametrize("fold,emit", KNOBS)
def test_engine_paths_match_reference(db, fold, emit):
    """count, evaluate and evaluate_stream of the bowtie at a capacity
    that splits morsels, and the LFTJ's evaluation."""
    q = bowtie_query()
    td, order, tdb, tq, ttd, tord = _plan(q, db)
    rk = dict(fold_kernel=REF_PATH[fold], emit_kernel=REF_PATH[emit])
    tk = dict(fold_kernel=fold, emit_kernel=emit)
    plan = dict(capacity=1 << 8)
    r = r_engine.evaluate(q, db, backend="jax", td=td, order=order,
                          **plan, **rk)
    t = t_engine.evaluate(tq, tdb, td=ttd, order=tord, device="cpu",
                          **plan, **tk)
    np.testing.assert_array_equal(t.tuples, np.asarray(r.tuples))
    for key in STATS:
        assert t.counters[key] == r.counters[key], key
    _assert_paths(t.counters, fold, emit, "evaluate")
    port_path = "chain" if fold == "chain" else "torch"
    assert t.fold_paths[port_path] == r.fold_paths[REF_PATH[fold]]
    assert (t.counters[_launch_key("emit", emit)]
            == r.counters[f"emit_calls_{REF_PATH[emit]}"])
    c = t_engine.count(tq, tdb, td=ttd, order=tord, device="cpu", **plan,
                       **tk)
    assert c.count == t.count == r_engine.count(
        q, db, backend="jax", td=td, order=order, **plan, **rk).count
    stream = t_engine.evaluate_stream(tq, tdb, td=ttd, order=tord,
                                      device="cpu", **plan, **tk)
    np.testing.assert_array_equal(np.concatenate(list(stream)), t.tuples)
    _assert_paths(stream.result.counters, fold, emit, "stream")
    rl = r_engine.evaluate(q, db, algorithm="lftj", backend="jax", td=td,
                           order=order, **plan, **rk)
    tl = t_engine.evaluate(tq, tdb, algorithm="lftj", td=ttd, order=tord,
                           device="cpu", **plan, **tk)
    np.testing.assert_array_equal(tl.tuples, np.asarray(rl.tuples))
    assert tl.counters[_launch_key("emit", emit)] > 0


@pytest.mark.parametrize("fold,emit", BOTH_WAYS)
def test_payload_cold_and_warm_match_reference(db, fold, emit):
    q = bowtie_query()
    td, order, tdb, tq, ttd, tord = _plan(q, db)
    ref = JaxCachedTrieJoin(q, td, order, db, capacity=1 << 8,
                            cache=rc.CacheConfig(**PAY),
                            fold_kernel=REF_PATH[fold],
                            emit_kernel=REF_PATH[emit])
    port = CachedTrieJoin(tq, ttd, tord, tdb, capacity=1 << 8,
                          cache=tc.CacheConfig(**PAY), device="cpu",
                          fold_kernel=fold, emit_kernel=emit)
    for what in ("cold", "warm"):
        rb = [np.asarray(b) for b in ref.evaluate()]
        tb = list(port.evaluate())
        assert len(tb) == len(rb) > 0, what
        for a, b in zip(tb, rb):
            np.testing.assert_array_equal(a, b, err_msg=what)
        for key in STATS:
            assert port.stats[key] == ref.stats[key], (what, key)
        with enable_x64():
            rstates = ref.cache.export_state()
        _assert_states_equal(port.cache.export_state(), rstates)
    assert port.stats["tier2_replay_hits"] > 0
    _assert_paths(port.stats, fold, emit, "payload")
    assert port.stats[_launch_key("fold_splice", fold)] > 0


@pytest.mark.parametrize("qname", ["bowtie", "path5"])
@pytest.mark.parametrize("fold,emit", BOTH_WAYS)
def test_static_matches_reference(zdb, fold, emit, qname):
    q = {"bowtie": bowtie_query(), "path5": path_query(5)}[qname]
    td, order, tdb, tq, ttd, tord = _plan(q, zdb)
    ref = RStatic(q, td, order, zdb, capacity=1 << 13,
                  cache=rc.CacheConfig(**STATIC_PAY),
                  fold_kernel=REF_PATH[fold], emit_kernel=REF_PATH[emit])
    port = TStatic(tq, ttd, tord, tdb, capacity=1 << 13,
                   cache=tc.CacheConfig(**STATIC_PAY), device="cpu",
                   fold_kernel=fold, emit_kernel=emit)
    with enable_x64():
        rtotal, rov = (x.item() for x in ref.count_fn()(
            ref.initial_frontier()))
        rtables = ref.make_tables("evaluate")
    ttotal, tov = port.count_fn()(port.initial_frontier())
    assert (int(ttotal), bool(tov)) == (rtotal, bool(rov))
    ttables = port.make_tables("evaluate")
    _same_tables(rtables, ttables, "fresh")
    cold, rtables, ttables = _same_eval_pass(ref, port, rtables, ttables,
                                             "cold")
    warm, _, _ = _same_eval_pass(ref, port, rtables, ttables, "warm")
    assert cold["count"] == warm["count"] == rtotal
    assert warm["tier2_replay_hits"] > 0
    st = port.stats
    for op, path in (("fold", fold), ("fold_merged", fold),
                     ("emit", emit)):
        assert st[_launch_key(op, path)] > 0, op
        assert st[f"{op}_calls_cuda"] == 0
    nested = qname == "path5"
    # the fused FOLD sorts an unsorted exit chunk first; the chain sorts
    # its exits itself
    assert (st["fold_sorted_exits"] > 0) == (nested and fold == "fused")


@pytest.mark.parametrize("arity", list(ARITIES))
def test_fused_fold_calls_the_wrapper_on_the_module(monkeypatch, arity):
    """On the fused path a CUDA chunk goes to the FOLD wrapper the module
    holds when the step is called, not when it was built (chip_smoke's
    captures replace a wrapper on the module after the engine built its
    steps); the chain path never calls a wrapper."""
    from repro_torch.kernels.fold import cuda as fold_cuda
    replay, splice = ARITIES[arity]
    spec = registry.FoldSpec(capacity=8, n_vars=3, n_atoms=2)
    fused, chain = (registry.fold_fn(spec, path=p, d0=0, d1=1,
                                     with_replay=replay, with_splice=splice)
                    for p in ("fused", "chain"))
    seen = []
    monkeypatch.setattr(fold_cuda, arity,
                        lambda *a, **kw: seen.append(kw) or "wrapper")
    monkeypatch.setattr(registry, "path_of", lambda t: "cuda")
    P = _to_torch(_merged_inputs(8, 0, {}, "both")[0])   # 5 columns, not 3
    rest = [None] * (3 * replay + 4 * splice)
    assert fused(P, *rest) == "wrapper"
    assert seen == [dict(d0=0, d1=1)]
    with pytest.raises(ValueError, match="assign"):
        chain(P, *rest)   # checked against the spec, no wrapper reached
    assert len(seen) == 1
