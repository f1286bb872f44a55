"""The port's bounded search and chain EXPAND (``impl="leapfrog"``,
``expand_kernel="chain"``, on the CPU) against the JAX reference's
(``impl="pallas"``: the leapfrog Pallas kernel in interpret mode, with
``expand_kernel="xla"``) on the same numpy inputs:

* ``leapfrog/plain.bound`` against the reference's ``lower_bound`` /
  ``upper_bound`` with ``impl="pallas"`` and ``impl="ref"`` on the
  reference sweep's cases (``tests/test_kernels.py``), and on windows that
  run past the column or are inverted; ``_bsearch`` against both on the
  sorted windows;
* ``chain.expand_step(impl="leapfrog")`` against the reference's
  ``xla.expand_step(impl="pallas")`` at every depth of the 4-cycle and the
  bowtie;
* ``engine.count`` / ``evaluate`` on the chain with the leapfrog search
  against the reference's: counts, tuples in block order, tier counters
  and ``device_get`` syncs;
* every bound call of such a run answers as ``_bsearch`` does on the
  slots the chain keeps (the sorted-window premise of the CUDA kernel).

Everything compared is an integer, so the tolerance is none."""
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
from repro.core.decompose import choose_plan
from repro.core.frontier import Frontier as RFrontier
from repro.core.hostsync import SyncCounter as RSyncCounter
from repro.kernels import registry as r_registry
from repro.kernels.expand import xla as r_expand_xla
from repro_torch.convert import from_reference
from repro_torch.core import cache as tc
from repro_torch.core import engine as t_engine
from repro_torch.core.cached_frontier import CachedTrieJoin
from repro_torch.core.frontier import Frontier as TFrontier
from repro_torch.core.hostsync import SyncCounter as TSyncCounter
from repro_torch.kernels import registry
from repro_torch.kernels.expand import chain
from repro_torch.kernels.leapfrog import plain as t_leapfrog

FIELDS = ("assign", "factor", "orig", "lo", "hi")
QUERIES = {"cycle-4": cycle_query(4), "bowtie": bowtie_query()}
# the reference sweep's (column length, queries)
SWEEP = [(0, 4), (1, 1), (7, 5), (100, 64), (1000, 513), (4096, 700)]
STATS = ["tier1_rows_collapsed", "tier2_replay_hits"] + [
    f"tier2_{k}" for k in ("hits", "misses", "probes", "inserts",
                           "evictions", "resizes", "payload_flushes",
                           "slab_rows")]


def _inputs(n, m, dtype, windows):
    """The reference sweep's inputs (same seed, same draws); ``windows``
    "past-n" lets hi run past the column, "inverted" gives lo > hi."""
    rng = np.random.default_rng(n * 1000 + m)
    col = np.sort(rng.integers(0, max(2 * n, 4), size=n)).astype(dtype)
    v = rng.integers(-3, max(2 * n, 4) + 3, size=m).astype(dtype)
    lo = rng.integers(0, n + 1, size=m).astype(np.int32)
    hi = np.minimum(n, lo + rng.integers(0, n + 1, size=m)).astype(np.int32)
    if windows == "past-n":
        hi = (lo + rng.integers(0, n + 9, size=m)).astype(np.int32)
    elif windows == "inverted":
        lo = rng.integers(0, n + 5, size=m).astype(np.int32)
        hi = (lo - rng.integers(1, 6, size=m)).astype(np.int32)
    return col, v, lo, hi


@pytest.mark.parametrize("windows", ["sweep", "past-n", "inverted"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,m", SWEEP)
def test_plain_bound_matches_reference_pallas_and_ref(n, m, dtype, windows):
    col, v, lo, hi = _inputs(n, m, dtype, windows)
    t_args = [torch.from_numpy(a) for a in (col, v, lo, hi)]
    for strict, r_fn, t_fn in ((True, r_registry.lower_bound,
                                registry.lower_bound),
                               (False, r_registry.upper_bound,
                                registry.upper_bound)):
        with enable_x64():
            r_args = [jnp.asarray(a) for a in (col, v, lo, hi)]
            want = {impl: np.asarray(r_fn(*r_args, impl=impl))
                    for impl in ("pallas", "ref")}
        np.testing.assert_array_equal(want["pallas"], want["ref"])
        got = {"plain": t_leapfrog.bound(*t_args, strict=strict),
               "leapfrog": t_fn(*t_args, impl="leapfrog"),
               "ref": t_fn(*t_args, impl="ref")}
        if windows == "sweep":  # sorted windows inside the column
            got["bsearch"] = t_fn(*t_args, impl="bsearch")
        for name, out in got.items():
            assert out.dtype == torch.int32, name
            for impl, w in want.items():
                np.testing.assert_array_equal(
                    out.numpy(), w, err_msg=f"port {name} vs reference "
                    f"{impl}, strict={strict}")


def test_plain_bound_is_a_dense_count_on_unsorted_columns():
    """The plain version counts as the TPU kernel does, sorted or not, in
    column blocks of any width."""
    rng = np.random.default_rng(7)
    n, m = 3000, 300
    col = rng.integers(0, 50, n).astype(np.int32)
    v = rng.integers(0, 50, m).astype(np.int32)
    lo = rng.integers(-5, n, m).astype(np.int32)
    hi = (lo + rng.integers(-3, n, m)).astype(np.int32)
    with enable_x64():
        want = np.asarray(r_registry.lower_bound(
            *(jnp.asarray(a) for a in (col, v, lo, hi)), impl="pallas"))
    t_args = [torch.from_numpy(a) for a in (col, v, lo, hi)]
    for block_c in (1, 100, 1024, 4096):
        got = t_leapfrog.bound(*t_args, strict=True, block_c=block_c)
        np.testing.assert_array_equal(got.numpy(), want)


def test_bound_impls_are_validated():
    col = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="impl must be one of"):
        registry.lower_bound(col, col, col, col, impl="pallas")


# ---------------------------------------------------------------------------
# The chain EXPAND, level by level
# ---------------------------------------------------------------------------

def _engines(q, capacity, seed=11, nv=8, ne=90):
    rng = np.random.default_rng(seed)
    db = graph_db(rng.integers(0, nv, size=(ne, 2)))
    td, order = choose_plan(q, db.stats())
    ref = JaxCachedTrieJoin(q, td, order, db, capacity=capacity)
    tdb, tq, ttd, tord = from_reference(
        db.relations, [(a.relation, a.vars) for a in q.atoms], td.bags,
        td.parent, order, td.children)
    port = CachedTrieJoin(tq, ttd, tord, tdb, capacity=capacity,
                          device="cpu", impl="leapfrog",
                          expand_kernel="chain")
    return ref, port


@pytest.mark.parametrize("qname", sorted(QUERIES))
@pytest.mark.parametrize("capacity", [1 << 6, 1 << 8])
def test_chain_leapfrog_matches_reference_xla_pallas(qname, capacity):
    """Every depth from the initial frontier, continuing from the
    reference's result; at C = 2^6 some levels overflow the chunk."""
    ref, port = _engines(QUERIES[qname], capacity)
    with enable_x64():
        F = ref.initial_frontier()
        for d in range(ref.n):
            ra, ta = ref.expand_kernel_args(d), port.expand_kernel_args(d)
            assert (ta["g_ai"], ta["other_ais"]) == (ra["g_ai"],
                                                     ra["other_ais"])
            Fr, nr = r_expand_xla.build(impl="pallas", **ra)(F)
            Ft, nt = chain.expand_step(
                TFrontier(*(torch.from_numpy(np.array(x)) for x in F)),
                ta["g_col"], ta["g_rs"], ta["other_cols"], d=d,
                g_ai=ta["g_ai"], other_ais=ta["other_ais"],
                n_rows_g=ta["n_rows_g"], impl="leapfrog")
            assert int(nt) == int(nr), f"d={d} needed"
            vr, vt = np.asarray(Fr.valid), Ft.valid.numpy()
            np.testing.assert_array_equal(vt, vr, err_msg=f"d={d} valid")
            k = int(vr.sum())
            for f in FIELDS:
                np.testing.assert_array_equal(
                    getattr(Ft, f)[:k].numpy(),
                    np.asarray(getattr(Fr, f))[:k], err_msg=f"d={d} {f}")
            F = RFrontier(*Fr)
    for d in range(ref.n):
        port._expand_fn(d)
    assert port.expand_paths == dict.fromkeys(range(ref.n), "chain")
    assert port._expand_fn(ref.n - 1).bound_calls == 2 * len(
        port.expand_kernel_args(ref.n - 1)["other_cols"])


def test_expand_knobs_are_validated():
    q = cycle_query(4)
    rng = np.random.default_rng(0)
    from repro_torch.core.db import graph_db as t_graph_db
    db = t_graph_db(rng.integers(0, 8, size=(30, 2)))
    with pytest.raises(ValueError, match="expand_kernel must be one of"):
        t_engine.count(q, db, device="cpu", expand_kernel="xla")
    with pytest.raises(ValueError, match="impl must be one of"):
        t_engine.count(q, db, device="cpu", impl="pallas")


# ---------------------------------------------------------------------------
# The engine on the chain with the leapfrog search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    return graph_db(rng.integers(0, 12, size=(80, 2)))


_PLANS = {}


def _plan(qname, db):
    if qname not in _PLANS:
        q = QUERIES[qname]
        td, order = r_engine.plan_query(q, db)
        _PLANS[qname] = (q, td, order) + from_reference(
            db.relations, [(a.relation, a.vars) for a in q.atoms], td.bags,
            td.parent, order, td.children)
    return _PLANS[qname]


CACHES = {"setassoc": dict(policy="setassoc", slots=64, assoc=4),
          "payload": dict(policy="setassoc", slots=64, assoc=4,
                          cache_payloads=True, payload_rows=1 << 12)}


@pytest.mark.parametrize("mode,cache", [("count", "setassoc"),
                                        ("evaluate", "setassoc"),
                                        ("evaluate", "payload")])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_engine_chain_leapfrog_matches_reference(db, qname, mode, cache):
    q, td, order, tdb, tq, ttd, tord = _plan(qname, db)
    cfg = CACHES[cache]
    extra = {"backend": "jax"} if mode == "evaluate" else {}
    with RSyncCounter() as rs:
        r = getattr(r_engine, mode)(q, db, td=td, order=order,
                                    capacity=1 << 8, impl="pallas",
                                    expand_kernel="xla",
                                    cache=rc.CacheConfig(**cfg), **extra)
    with TSyncCounter() as ts:
        t = getattr(t_engine, mode)(tq, tdb, td=ttd, order=tord,
                                    capacity=1 << 8, impl="leapfrog",
                                    expand_kernel="chain",
                                    cache=tc.CacheConfig(**cfg),
                                    device="cpu")
    assert t.count == r.count > 0
    if mode == "evaluate":
        np.testing.assert_array_equal(t.tuples, np.asarray(r.tuples))
    for k in STATS:
        assert t.counters.get(k, 0) == r.counters.get(k, 0), k
    assert ts.count == rs.count
    assert ts.label_counts == rs.label_counts
    assert t.counters["expand_calls_chain"] == r.counters[
        "expand_calls_xla"] > 0
    assert t.counters["expand_calls_torch"] == 0
    assert t.counters["bound_calls_torch"] > 0
    assert t.counters["bound_calls_cuda"] == 0


def test_every_bound_call_answers_as_bsearch_on_kept_slots(db, monkeypatch):
    """The CUDA kernel's premise: on every slot below ``needed`` the chain
    searches a sorted window, where a binary search and the dense count
    agree.  A spy checks each leapfrog bound call of a whole run."""
    q, td, order, tdb, tq, ttd, tord = _plan("bowtie", db)
    calls, checked = [], []
    orig_bound, orig_step = registry._bound, chain.expand_step

    def bound(col, values, lo, hi, strict, impl):
        out = orig_bound(col, values, lo, hi, strict, impl)
        calls.append((col, values, lo, hi, strict, out))
        return out

    def step(F, *args, **kw):
        calls.clear()
        out, needed = orig_step(F, *args, **kw)
        k = min(int(needed), F.assign.shape[0])
        for col, values, lo, hi, strict, got in calls:
            want = registry._bsearch(col, values, lo, hi, strict=strict)
            assert torch.equal(got[:k], want[:k])
            checked.append(k)
        return out, needed

    monkeypatch.setattr(registry, "_bound", bound)
    monkeypatch.setattr(chain, "expand_step", step)
    res = [t_engine.count(tq, tdb, td=ttd, order=tord, capacity=1 << 6,
                          impl="leapfrog", expand_kernel="chain",
                          device="cpu"),
           t_engine.evaluate(tq, tdb, td=ttd, order=tord, capacity=1 << 6,
                             impl="leapfrog", expand_kernel="chain",
                             device="cpu")]
    assert len(checked) == sum(r.counters["bound_calls_torch"]
                               for r in res) > 0
    assert sum(checked) > 0
