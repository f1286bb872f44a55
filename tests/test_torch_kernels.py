"""Each plain kernel of the port (``repro_torch.kernels.*.plain``) against
the JAX reference on the same numpy inputs: the XLA chain, the Pallas
kernel in interpret mode, and the numpy oracle.  Everything compared is
an integer, so the tolerance is none: the valid prefix and the scalar
outputs (``needed``, ``stats``, ``k``) must be equal bit for bit; rows
past the valid prefix are unconstrained except that they are invalid."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.core.cached_frontier import JaxCachedTrieJoin
from repro.core.cq import bowtie_query, cycle_query, star_query
from repro.core.db import graph_db
from repro.core.decompose import choose_plan
from repro.core.frontier import Frontier as RFrontier
from repro.kernels.emit import emit_ref
from repro.kernels.emit import fused as r_emit_fused, xla as r_emit_xla
from repro.kernels.expand import FusedExpandConfig, expand_ref
from repro.kernels.expand import fused as r_expand_fused
from repro.kernels.expand import xla as r_expand_xla
from repro.kernels.fold import FusedFoldConfig, fold_ref
from repro.kernels.fold import fused as r_fold_fused, xla as r_fold_xla
from repro.kernels.emit.fused import FusedEmitConfig
from repro_torch.convert import from_reference
from repro_torch.core.cached_frontier import CachedTrieJoin
from repro_torch.core.frontier import Frontier as TFrontier
from repro_torch.core.schedule import _sort_exits
from repro_torch.kernels import registry
from repro_torch.kernels.emit import plain as t_emit
from repro_torch.kernels.expand import plain as t_expand
from repro_torch.kernels.fold import plain as t_fold

FIELDS = ("assign", "factor", "orig", "lo", "hi")


def _to_torch(F):
    return TFrontier(*(torch.from_numpy(np.array(x)) for x in F))


def _to_jax(F):
    return RFrontier(*(jnp.asarray(np.asarray(x)) for x in F))


def _host(F):
    return RFrontier(*(np.asarray(x) for x in F))


def _assert_chunks_equal(a, b, msg):
    """Same valid mask shape (a prefix), same valid prefix."""
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    ka, kb = int(va.sum()), int(vb.sum())
    assert ka == kb, f"{msg}: {ka} != {kb} valid rows"
    assert va[:ka].all() and vb[:kb].all(), f"{msg}: not a valid prefix"
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f))[:ka],
                                      np.asarray(getattr(b, f))[:kb],
                                      err_msg=f"{msg}: {f}")
    return ka


# ---------------------------------------------------------------------------
# EXPAND, level by level on real engines
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
                          device="cpu")
    return ref, port


def _expand_all_ways(ref, port, F, d):
    ra = ref.expand_kernel_args(d)
    ta = port.expand_kernel_args(d)
    assert (ta["g_ai"], ta["other_ais"]) == (ra["g_ai"], ra["other_ais"])
    Fx, nx = r_expand_xla.build(impl="bsearch", **ra)(F)
    Fp, npl = r_expand_fused.build(
        config=FusedExpandConfig(interpret=True), **ra)(F)
    kw = dict(d=d, g_ai=ta["g_ai"], other_ais=ta["other_ais"],
              n_rows_g=ta["n_rows_g"])
    Ft, nt = t_expand.expand_step(_to_torch(F), ta["g_col"], ta["g_rs"],
                                  ta["other_cols"], **kw)
    assert int(nt) == int(nx) == int(npl)
    k = _assert_chunks_equal(Ft, Fx, f"d={d} plain vs xla")
    _assert_chunks_equal(Ft, Fp, f"d={d} plain vs pallas")
    if int(nt) <= F.assign.shape[0]:  # the oracle does not truncate
        host = {f: np.asarray(x) for f, x in F._asdict().items()}
        rows, needed = expand_ref(
            host, np.asarray(ra["g_col"]), np.asarray(ra["g_rs"]),
            [np.asarray(c) for c in ra["other_cols"]], d=d, g_ai=ra["g_ai"],
            other_ais=ra["other_ais"], n_rows_g=ra["n_rows_g"])
        assert needed == int(nt) and rows["assign"].shape[0] == k
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(Ft, f)[:k].numpy(),
                                          rows[f], err_msg=f"d={d} {f}")
    return Fx


@pytest.mark.parametrize("qname,q,capacity",
                         [("cycle-5", cycle_query(5), 1 << 8),
                          ("star-3", star_query(3), 1 << 10),
                          ("bowtie", bowtie_query(), 1 << 8)])
def test_expand_plain_matches_reference_level_by_level(qname, q, capacity):
    """Walk every depth from the initial frontier, continuing from the XLA
    result, so each level sees a realistic chunk."""
    ref, port = _engines(q, capacity)
    with enable_x64():
        F = ref.initial_frontier()
        for d in range(ref.n):
            F = _expand_all_ways(ref, port, F, d)


def test_expand_tiny_capacity_truncates_like_reference():
    """A chunk whose candidates exceed the capacity (the executor splits
    such chunks first): every path truncates the slot enumeration the
    same way and reports the same uncapped ``needed``."""
    ref, port = _engines(star_query(3), 1 << 8, nv=40, ne=1500)
    with enable_x64():
        F = ref.initial_frontier()
        F, _ = r_expand_xla.build(impl="bsearch",
                                  **ref.expand_kernel_args(0))(F)
        grown = 0
        for d in range(1, ref.n):
            _expand_all_ways(ref, port, F, d)
            _, needed = r_expand_xla.build(
                impl="bsearch", **ref.expand_kernel_args(d))(F)
            grown = max(grown, int(needed))
        assert grown > F.assign.shape[0], "case must overflow capacity"


def test_expand_registry_dispatches_cpu_to_plain():
    ref, port = _engines(cycle_query(4), 1 << 8)
    fn = port._expand_fn(0)
    with enable_x64():
        F = ref.initial_frontier()
        Fx, nx = r_expand_xla.build(impl="bsearch",
                                    **ref.expand_kernel_args(0))(F)
    Ft, nt = fn(port.initial_frontier())
    assert registry.path_of(Ft.assign) == "torch"
    assert int(nt) == int(nx)
    _assert_chunks_equal(Ft, Fx, "registry")


@pytest.mark.parametrize("n,m", [(2, 2), (5, 3), (8, 8)])
@pytest.mark.parametrize("C", [1, 1000, 1 << 16, 1 << 25])
def test_expand_scratch_layout(C, n, m):
    """The CUDA EXPAND's scratch (``kernels/expand/cuda.py``): one 64-bit
    status word a tile of 1024 rows or slots for each of its two
    single-pass scans, at even int32 offsets (8-byte aligned), two
    tickets, a source row for each tile of slots, then r0, cnt and off;
    no staged rows, so nothing grows with n or m.  Computed without
    CUDA."""
    from repro_torch.kernels.expand import cuda as t_expand_cuda
    lay = t_expand_cuda.scratch_layout(C, n, m)
    tiles = -(-C // 1024)
    assert t_expand_cuda.TILE == 1024
    assert tiles * 1024 >= C > (tiles - 1) * 1024
    assert lay["plan_status"] == (0, 2 * tiles)
    assert lay["slot_status"] == (2 * tiles, 2 * tiles)
    assert lay["tickets"] == (4 * tiles, 2)
    assert lay["tile_src"] == (4 * tiles + 2, tiles)
    at = 5 * tiles + 2
    for name in ("r0", "cnt", "off"):
        assert lay[name] == (at, C), name
        at += C
    assert lay["total"] == (0, at) == (0, 5 * tiles + 2 + 3 * C)
    assert lay == t_expand_cuda.scratch_layout(C, 1, 1)


# ---------------------------------------------------------------------------
# FOLD, replay-only arity
# ---------------------------------------------------------------------------

def _fold_inputs(C, seed, n=5, m=3, n_parents=None, n_exits=None,
                 n_reps=None):
    """(P, active, rep_of_row, E) with the exits valid-prefix compacted
    and their orig nondecreasing (the sorted-exits invariant)."""
    rng = np.random.default_rng(seed)
    n_parents = n_parents or C // 5
    n_exits = n_exits or C // 3
    n_reps = n_reps or max(2, C // 16)

    def chunk(k, orig):
        lo = rng.integers(0, 9, size=(C, m)).astype(np.int32)
        return RFrontier(
            rng.integers(0, 40, size=(C, n)).astype(np.int32),
            rng.integers(1, 5, size=(C,)).astype(np.int64),
            np.arange(C) < k, np.asarray(orig, np.int32), lo,
            lo + rng.integers(0, 4, size=(C, m)).astype(np.int32))

    P = chunk(n_parents, np.sort(rng.integers(0, C, size=(C,))))
    active = (np.arange(C) < n_parents) & (rng.random(C) < 0.8)
    rep_of_row = rng.integers(0, n_reps, size=(C,)).astype(np.int32)
    eorig = np.full((C,), n_reps - 1, np.int32)
    eorig[:n_exits] = np.sort(rng.integers(0, n_reps, size=(n_exits,)))
    E = chunk(n_exits, eorig)
    return P, active, rep_of_row, E


FOLD_CASES = [(1 << 8, 0, {}), (1 << 8, 1, {}), (1 << 10, 2, {}),
              (1 << 12, 3, {}),
              # more pairs than the capacity: truncated, needed uncapped
              (1 << 8, 4, dict(n_parents=200, n_exits=250, n_reps=4))]


@pytest.mark.parametrize("C,seed,kw", FOLD_CASES)
def test_fold_replay_plain_matches_reference(C, seed, kw):
    d0, d1 = 1, 3
    P, active, ror, E = _fold_inputs(C, seed, **kw)
    ref = fold_ref(P, active, ror, E, d0=d0, d1=d1)
    with enable_x64():
        args = (_to_jax(P), jnp.asarray(active), jnp.asarray(ror),
                _to_jax(E))
        Fx, sx = r_fold_xla.build(d0=d0, d1=d1, with_replay=True,
                                  with_splice=False)(*args)
        Fp, sp = r_fold_fused.build(
            d0=d0, d1=d1, with_replay=True, with_splice=False,
            config=FusedFoldConfig(interpret=True))(*args)
    Ft, st = t_fold.replay(_to_torch(P), torch.from_numpy(active),
                           torch.from_numpy(ror), _to_torch(E), d0=d0, d1=d1)
    assert st.dtype == torch.int64
    for s in (np.asarray(sx), np.asarray(sp), ref[5]):
        np.testing.assert_array_equal(st.numpy(), s)
    k = _assert_chunks_equal(Ft, Fx, "plain vs xla")
    _assert_chunks_equal(Ft, Fp, "plain vs pallas")
    assert k == ref[0].shape[0]
    for f, r in zip(FIELDS, ref[:5]):
        np.testing.assert_array_equal(getattr(Ft, f)[:k].numpy(), r,
                                      err_msg=f)
    if kw:
        assert int(st[0]) > C, "case must overflow capacity"


def _merged_inputs(C, seed, kw, side, w=3):
    """Replay inputs plus payload hits on the parents that do not replay
    (the executor's ``active = valid & ~hit``), with their blocks in a slab
    whose last row is scratch.  ``side`` empties one side (``no-replay``,
    ``no-splice``) or shuffles the exit chunk (``unsorted``)."""
    P, active, ror, E = _fold_inputs(C, seed, **kw)
    rng = np.random.default_rng(seed + 100)
    hit = np.asarray(P.valid) & ~active & (rng.random(C) < 0.7)
    if side == "no-replay":
        hit, active = np.asarray(P.valid).copy(), np.zeros(C, bool)
    elif side == "no-splice":
        hit = np.zeros(C, bool)
    plen = np.where(hit, rng.integers(1, 6, size=C), 0).astype(np.int32)
    slab_rows = 300
    poff = np.where(hit, rng.integers(0, slab_rows - 6, size=C),
                    0).astype(np.int32)
    slab = rng.integers(0, 1 << 20, size=(slab_rows + 1, w)).astype(np.int32)
    if side == "unsorted":
        perm = rng.permutation(C)
        E = RFrontier(*(np.asarray(x)[perm] for x in E))
    return P, active, ror, E, hit, poff, plen, slab


MERGED_CASES = [
    pytest.param(C, seed, kw, "both", id=f"C{C}-seed{seed}")
    for C, seed, kw in FOLD_CASES] + [
    # the replay fits, replay + splice does not: the splice is cut short
    pytest.param(1 << 8, 5, dict(n_parents=120, n_exits=200, n_reps=40),
                 "both", id="splice-truncated"),
    pytest.param(1 << 8, 6, {}, "no-replay", id="no-replay"),
    pytest.param(1 << 8, 7, {}, "no-splice", id="no-splice"),
    pytest.param(1 << 8, 8, {}, "unsorted", id="unsorted-exits")]


@pytest.mark.parametrize("C,seed,kw,side", MERGED_CASES)
def test_fold_merged_plain_matches_reference(C, seed, kw, side):
    """The merged arity ``[replay | splice]``: the port's plain version
    against the reference's XLA chain, its Pallas kernel in interpret
    mode and the numpy oracle.  An unsorted exit chunk goes to the XLA
    chain as it is (the reference's route for it) and, stably sorted by
    the static executor's ``_sort_exits``, to the Pallas kernel and the
    port: both routes must give the same rows."""
    d0, d1 = 1, 3
    P, active, ror, E, hit, poff, plen, slab = _merged_inputs(C, seed, kw,
                                                              side)
    Et = _to_torch(E)
    Es = _host(_sort_exits(Et)) if side == "unsorted" else E
    ref = fold_ref(P, active, ror, E, hit, poff, plen, slab, d0=d0, d1=d1)
    with enable_x64():
        pay = (jnp.asarray(hit), jnp.asarray(poff), jnp.asarray(plen),
               jnp.asarray(slab))
        Fx, sx = r_fold_xla.build(d0=d0, d1=d1, with_replay=True,
                                  with_splice=True)(
            _to_jax(P), jnp.asarray(active), jnp.asarray(ror), _to_jax(E),
            *pay)
        Fp, sp = r_fold_fused.build(
            d0=d0, d1=d1, with_replay=True, with_splice=True,
            config=FusedFoldConfig(interpret=True))(
            _to_jax(P), jnp.asarray(active), jnp.asarray(ror), _to_jax(Es),
            *pay)
    args = (_to_torch(P), torch.from_numpy(active), torch.from_numpy(ror))
    tpay = tuple(torch.from_numpy(x) for x in (hit, poff, plen, slab))
    Ft, st = t_fold.merged(*args, _to_torch(Es), *tpay, d0=d0, d1=d1)
    assert st.dtype == torch.int64
    for s_ in (np.asarray(sx), np.asarray(sp), ref[5]):
        np.testing.assert_array_equal(st.numpy(), s_)
    k = _assert_chunks_equal(Ft, Fx, "plain vs xla")
    _assert_chunks_equal(Ft, Fp, "plain vs pallas")
    assert k == ref[0].shape[0] == min(int(st[2]), C)
    for f, r in zip(FIELDS, ref[:5]):
        np.testing.assert_array_equal(getattr(Ft, f)[:k].numpy(), r,
                                      err_msg=f)
    needed, n_spl = int(st[0]), int(st[1])
    if side == "unsorted":
        Fu, su = t_fold.merged(*args, Et, *tpay, d0=d0, d1=d1)
        assert torch.equal(su, st)
        _assert_chunks_equal(Fu, Ft, "unsorted vs sorted exits")
    if side == "no-replay":
        assert needed == 0 and n_spl > 0
    if side == "no-splice":
        assert n_spl == 0 and needed > 0
    if kw:
        assert min(needed, C) + n_spl > C, "case must truncate"


def test_fold_registry_checks_shapes():
    C = 1 << 8
    P, active, ror, E = _fold_inputs(C, 0)
    fn = registry.fold_fn(registry.FoldSpec(capacity=C, n_vars=5,
                                            n_atoms=3), d0=1, d1=3)
    Ft, _ = fn(_to_torch(P), torch.from_numpy(active),
               torch.from_numpy(ror), _to_torch(E))
    assert Ft.assign.shape == (C, 5)
    with pytest.raises(ValueError):
        fn(_to_torch(P), torch.from_numpy(active),
           torch.from_numpy(ror).long(), _to_torch(E))


@pytest.mark.parametrize("arity", ["replay", "splice", "merged"])
@pytest.mark.parametrize("C", [1, 1000, 1025, 1 << 16, 1 << 25])
def test_fold_scratch_layout(C, arity):
    """The CUDA FOLD's scratch (``kernels/fold/cuda.py``), one layout an
    arity: one 64-bit status word a tile of 1024 parent rows for each
    single-pass scan of its plan (the merged arity scans replay and
    splice counts side by side), at even int32 offsets (8-byte aligned)
    from 0, then the ticket (these are what the memset clears), a source
    row for each tile of output slots an offset array, then plb and the
    offsets (C each).  Computed without CUDA."""
    from repro_torch.kernels.fold import cuda as t_fold_cuda
    lay = t_fold_cuda.scratch_layout(C, arity)
    tiles = -(-C // 1024)
    assert t_fold_cuda.TILE == 1024
    assert tiles * 1024 >= C > (tiles - 1) * 1024
    scans = {"replay": ["replay"], "splice": ["splice"],
             "merged": ["replay", "splice"]}[arity]
    at = 0
    for side in scans:
        assert lay[f"{side}_status"] == (at, 2 * tiles), side
        assert at % 2 == 0
        at += 2 * tiles
    assert lay["ticket"] == (at, 1)
    zeroed = at + 1
    at = zeroed
    for side in scans:
        assert lay[f"{side}_tile_src"] == (at, tiles), side
        at += tiles
    arrays = {"replay": ["plb", "roff"], "splice": ["soff"],
              "merged": ["plb", "roff", "soff"]}[arity]
    for name in arrays:
        assert lay[name] == (at, C), name
        at += C
    assert lay["total"] == (0, at)
    assert at == len(scans) * 3 * tiles + 1 + len(arrays) * C
    assert set(lay) == {f"{x}_status" for x in scans} | {
        f"{x}_tile_src" for x in scans} | set(arrays) | {"ticket", "total"}
    with pytest.raises(ValueError, match="arity"):
        t_fold_cuda.scratch_layout(C, "both")


# ---------------------------------------------------------------------------
# EMIT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,density,seed", [(1 << 8, 0.0, 0),
                                            (1 << 8, 0.3, 1),
                                            (1 << 10, 1.0, 2),
                                            (1 << 12, 0.5, 3)])
def test_emit_plain_matches_reference(C, density, seed):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, 1 << 20, size=(C, 4)).astype(np.int32)
    valid = rng.random(C) < density
    want = emit_ref(assign, valid)
    px, kx = r_emit_xla.build()(jnp.asarray(assign), jnp.asarray(valid))
    pp, kp = r_emit_fused.build(config=FusedEmitConfig(interpret=True))(
        jnp.asarray(assign), jnp.asarray(valid))
    pt, kt = t_emit.pack(torch.from_numpy(assign), torch.from_numpy(valid))
    k = int(kt)
    assert kt.dtype == torch.int32 and kt.dim() == 0
    assert k == int(kx) == int(kp) == want.shape[0]
    np.testing.assert_array_equal(pt[:k].numpy(), want)
    np.testing.assert_array_equal(pt[:k].numpy(), np.asarray(px)[:k])
    np.testing.assert_array_equal(pt[:k].numpy(), np.asarray(pp)[:k])


@pytest.mark.parametrize("C", [1, 1000, 1025, 1 << 16, 1 << 25])
def test_emit_scratch_layout(C):
    """The CUDA EMIT's scratch (``kernels/emit/cuda.py``): one 64-bit
    status word a tile of 1024 rows from offset 0 (8-byte aligned), then
    the ticket, and nothing else: no scan array grows with C.  Computed
    without CUDA."""
    from repro_torch.kernels.emit import cuda as t_emit_cuda
    lay = t_emit_cuda.scratch_layout(C)
    tiles = -(-C // 1024)
    assert t_emit_cuda.TILE == 1024
    assert tiles * 1024 >= C > (tiles - 1) * 1024
    assert lay == {"status": (0, 2 * tiles), "ticket": (2 * tiles, 1),
                   "total": (0, 2 * tiles + 1)}


# ---------------------------------------------------------------------------
# The bounded search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strict", [True, False])
def test_bsearch_matches_reference(strict):
    from repro.kernels.registry import _bsearch as r_bsearch
    rng = np.random.default_rng(7)
    col = np.sort(rng.integers(0, 50, size=301)).astype(np.int32)
    lo = rng.integers(0, 301, size=500).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 80, size=500), 301).astype(np.int32)
    vals = rng.integers(-5, 55, size=500).astype(np.int32)
    want = np.asarray(r_bsearch(jnp.asarray(col), jnp.asarray(vals),
                                jnp.asarray(lo), jnp.asarray(hi),
                                strict=strict))
    got = registry._bsearch(*(torch.from_numpy(a) for a in
                              (col, vals, lo, hi)), strict=strict)
    np.testing.assert_array_equal(got.numpy(), want)
