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
from repro.kernels.leapfrog import leapfrog as r_leapfrog
from repro_torch.convert import from_reference
from repro_torch.core import cache as tc
from repro_torch.core import engine as t_engine
from repro_torch.core.cached_frontier import CachedTrieJoin
from repro_torch.core.frontier import Frontier as TFrontier
from repro_torch.core.hostsync import SyncCounter as TSyncCounter
from repro_torch.kernels import registry
from repro_torch.kernels.expand import chain
from repro_torch.kernels.leapfrog import cuda as t_leapfrog_cuda
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
    # one membership test (one ctj_bound_atoms launch on the card) an
    # EXPAND with a membership atom, none without
    for d in range(ref.n):
        assert port._expand_fn(d).bound_calls == int(bool(
            port.expand_kernel_args(d)["other_cols"]))
    assert port._expand_fn(ref.n - 1).bound_calls == 1


# ---------------------------------------------------------------------------
# The membership test of one chain EXPAND (every atom's bounds at once)
# ---------------------------------------------------------------------------

def _atom_calls(qname, monkeypatch, capacity=1 << 6):
    """The inputs of every membership test of a level-by-level chain run
    of ``qname`` on the CPU (each depth from the last one's frontier),
    copied before the call, with each depth's frontier before its
    EXPAND."""
    _, port = _engines(QUERIES[qname], capacity)
    calls, orig = [], chain.bound_atoms

    def spy(cols, ais, values, ok, lo2, hi2, **kw):
        calls.append((cols, ais) + tuple(t.clone() for t in
                                         (values, ok, lo2, hi2)))
        orig(cols, ais, values, ok, lo2, hi2, **kw)

    monkeypatch.setattr(chain, "bound_atoms", spy)
    F, frontiers = port.initial_frontier(), []
    for d in range(port.n):
        a = port.expand_kernel_args(d)
        frontiers.append(F)
        F, _ = chain.expand_step(F, a["g_col"], a["g_rs"], a["other_cols"],
                                 d=d, g_ai=a["g_ai"],
                                 other_ais=a["other_ais"],
                                 n_rows_g=a["n_rows_g"], impl="leapfrog")
    monkeypatch.setattr(chain, "bound_atoms", orig)
    return port, calls, frontiers


@pytest.mark.parametrize("case", ["chain", "shuffled", "all-dead",
                                  "empty-column"])
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_plain_bound_atoms_matches_reference_pallas_per_atom(qname, case,
                                                             monkeypatch):
    """``plain.bound_atoms`` on the chain's own membership tests (and on
    them with the values shuffled across slots, with ``ok`` all False,
    with the last atom's column empty) against the reference's Pallas
    bounds in interpret mode, atom by atom as its chain calls them: ``ok``
    and both windows on every slot (both are dense counts)."""
    _, calls, _ = _atom_calls(qname, monkeypatch)
    # the bowtie's shared vertex lies in four atoms: a depth with three
    # membership atoms besides the guard
    assert max(len(c[1]) for c in calls) == (3 if qname == "bowtie" else 1)
    rng = np.random.default_rng(5)
    live = 0
    for cols, ais, values, ok, lo2, hi2 in calls:
        if not cols:
            continue
        if case == "shuffled":
            values = values[torch.from_numpy(rng.permutation(len(values)))]
        elif case == "all-dead":
            ok = torch.zeros_like(ok)
        elif case == "empty-column":
            cols = cols[:-1] + (cols[-1][:0],)
        want = [ok.numpy().copy(), lo2.numpy().copy(), hi2.numpy().copy()]
        with enable_x64():
            for col, ai in zip(cols, ais):
                c, v = jnp.asarray(col.numpy()), jnp.asarray(values.numpy())
                hi = jnp.asarray(want[2][:, ai])
                s = r_leapfrog.lower_bound_pallas(
                    c, v, jnp.asarray(want[1][:, ai]), hi)
                e = np.asarray(r_leapfrog.upper_bound_pallas(c, v, s, hi))
                s = np.asarray(s)
                want[0] &= s < e
                want[1][:, ai], want[2][:, ai] = s, e
        got = [ok.clone(), lo2.clone(), hi2.clone()]
        t_leapfrog.bound_atoms(cols, ais, values, *got)
        for g, w, what in zip(got, want, ("ok", "lo2", "hi2")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
        live += int(want[0].sum())
    assert (live > 0) == (case in ("chain", "shuffled"))


@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_chain_leapfrog_with_no_candidates_matches_reference(qname,
                                                             monkeypatch):
    """needed = 0: every depth's frontier with no valid row, through the
    port's chain and the reference's ``xla.expand_step(impl="pallas")``;
    the membership test runs on all-dead slots and keeps them dead."""
    ref, port = _engines(QUERIES[qname], 1 << 6)
    _, _, frontiers = _atom_calls(qname, monkeypatch)
    for d, F in enumerate(frontiers):
        F = F._replace(valid=torch.zeros_like(F.valid))
        ra, ta = ref.expand_kernel_args(d), port.expand_kernel_args(d)
        with enable_x64():
            Fr, nr = r_expand_xla.build(impl="pallas", **ra)(
                RFrontier(*(jnp.asarray(x.numpy()) for x in F)))
        Ft, nt = chain.expand_step(
            F, ta["g_col"], ta["g_rs"], ta["other_cols"], d=d,
            g_ai=ta["g_ai"], other_ais=ta["other_ais"],
            n_rows_g=ta["n_rows_g"], impl="leapfrog")
        assert int(nt) == int(nr) == 0, d
        assert not Ft.valid.any() and not np.asarray(Fr.valid).any(), d


def test_bound_atoms_dispatch_by_chunk_device():
    """A CPU chunk runs the plain version; the CUDA kernel's column layout
    refuses columns off the card, of another dtype or not contiguous, and
    the built chain EXPAND lays none out for CPU columns."""
    col = torch.tensor([1, 3, 3, 7], dtype=torch.int32)
    lo2 = torch.zeros((3, 2), dtype=torch.int32)
    hi2 = torch.full((3, 2), 4, dtype=torch.int32)
    ok = torch.tensor([True, True, False])
    values = torch.tensor([3, 4, 7], dtype=torch.int32)
    registry.bound_atoms((col,), (1,), values, ok, lo2, hi2, impl="leapfrog")
    assert ok.tolist() == [True, False, False]
    assert (lo2[0].tolist(), hi2[0].tolist()) == ([0, 1], [4, 3])
    for bad in (col, col.long(), torch.arange(8, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="kernel runs on|kernel takes|"
                           "not contiguous"):
            t_leapfrog_cuda.Atoms((bad,), (1,))
    with pytest.raises(ValueError, match="columns for"):
        t_leapfrog_cuda.Atoms((col,), (1, 2))
    assert t_leapfrog_cuda.Atoms((), ()).groups == []


@pytest.mark.parametrize("impl", registry.BOUND_IMPLS)
@pytest.mark.parametrize("qname", sorted(QUERIES))
def test_registry_bound_atoms_is_one_loop_for_every_impl(qname, impl,
                                                         monkeypatch):
    """``registry.bound_atoms`` on a CPU chunk, under every ``impl``, on
    the chain's own membership tests: ``ok`` as the dense count gives it
    on every slot, the windows on every slot whose final ``ok`` is set
    (each impl's search agrees with the dense count on sorted windows)."""
    _, calls, _ = _atom_calls(qname, monkeypatch)
    kept = 0
    for cols, ais, values, ok, lo2, hi2 in calls:
        got, want = ([t.clone() for t in (ok, lo2, hi2)] for _ in range(2))
        registry.bound_atoms(cols, ais, values, *got, impl=impl)
        t_leapfrog.bound_atoms(cols, ais, values, *want)
        keep = want[0]
        assert torch.equal(got[0], keep)
        assert torch.equal(got[1][keep], want[1][keep])
        assert torch.equal(got[2][keep], want[2][keep])
        kept += int(keep.sum())
    assert kept > 0


def test_an_empty_membership_column_makes_no_bound_call():
    """An EXPAND op with an empty membership column keeps no slot: its
    built chain step counts no leapfrog bound call, the kernel's column
    layout holds no group, and the chain still runs the membership test
    (clearing every slot) on the CPU."""
    col = torch.tensor([1, 3, 3, 7], dtype=torch.int32)
    empty = col[:0]
    spec = registry.ExpandSpec(capacity=4, n_vars=2, n_atoms=3, n_others=2)
    kw = dict(d=1, g_ai=0, other_ais=(1, 2), g_col=col,
              g_rs=torch.tensor([0, 1, 3], dtype=torch.int32), n_rows_g=4)
    full = registry.expand_fn(spec, path="chain", impl="leapfrog",
                              other_cols=(col, col), **kw)
    cut = registry.expand_fn(spec, path="chain", impl="leapfrog",
                             other_cols=(col, empty), **kw)
    assert (full.bound_calls, cut.bound_calls) == (1, 0)
    assert t_leapfrog_cuda.Atoms((col[:0],), (1,)).groups == []
    F = TFrontier(assign=torch.zeros((4, 2), dtype=torch.int32),
                  factor=torch.ones(4, dtype=torch.int64),
                  valid=torch.tensor([True, False, False, False]),
                  orig=torch.arange(4, dtype=torch.int32),
                  lo=torch.zeros((4, 3), dtype=torch.int32),
                  hi=torch.full((4, 3), 4, dtype=torch.int32))
    Ff, nf = full(F)
    Fc, nc = cut(F)
    assert int(nf) == int(nc) == 3
    assert Ff.valid.tolist() == [True, True, True, False]
    assert not Fc.valid.any()


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
    """The CUDA kernel's premise: on every live slot the chain searches a
    sorted window, where a binary search and the dense count agree.  A
    spy checks each leapfrog membership test of a whole run: ``ok`` as a
    binary search gives it on every slot below ``needed``, the windows on
    every slot whose final ``ok`` is set."""
    q, td, order, tdb, tq, ttd, tord = _plan("bowtie", db)
    calls, checked = [], []
    orig_atoms, orig_step = chain.bound_atoms, chain.expand_step

    def atoms(cols, ais, values, ok, lo2, hi2, **kw):
        before = tuple(t.clone() for t in (ok, lo2, hi2))
        registry.bound_atoms(cols, ais, values, *before, impl="bsearch")
        orig_atoms(cols, ais, values, ok, lo2, hi2, **kw)
        if cols:
            calls.append((before, (ok.clone(), lo2.clone(), hi2.clone())))

    def step(F, *args, **kw):
        calls.clear()
        out, needed = orig_step(F, *args, **kw)
        k = min(int(needed), F.assign.shape[0])
        for (ok_w, lo_w, hi_w), (ok, lo2, hi2) in calls:
            assert torch.equal(ok[:k], ok_w[:k])
            assert not ok[k:].any()
            assert torch.equal(lo2[ok], lo_w[ok])
            assert torch.equal(hi2[ok], hi_w[ok])
            checked.append(int(ok.sum()))
        return out, needed

    monkeypatch.setattr(chain, "bound_atoms", atoms)
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
