"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker: these skip where CUDA is missing; run them on a
GPU machine with ``python -m pytest -m cuda tests/test_torch_cuda.py``).

The join's outputs are integers, so their tolerance is none: the valid
prefix and the scalar outputs must be equal bit for bit.  Flash
attention's tolerance is the reference sweep's (``tests/test_kernels.py``):
2e-5 in fp32 and 2e-2 in bf16, absolute and relative, since the kernel
sums in another order than the plain version and a bf16 output may round
to a neighbouring value."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.cache import CacheConfig
from repro_torch.core.cq import (bowtie_query, cycle_query, lollipop_query,
                                 path_query, star_query)
from repro_torch.core.db import graph_db
from repro_torch.core.frontier import Frontier
from repro_torch.kernels.emit import cuda as emit_cuda, plain as emit_plain
from repro_torch.kernels.expand import cuda as expand_cuda
from repro_torch.kernels.expand import plain as expand_plain
from repro_torch.kernels.flash_attention import cuda as flash_cuda
from repro_torch.kernels.flash_attention import plain as flash_plain
from repro_torch.kernels.fold import cuda as fold_cuda, plain as fold_plain
from repro_torch.kernels.leapfrog import cuda as bound_cuda
from repro_torch.kernels.leapfrog import plain as bound_plain

pytestmark = pytest.mark.cuda

FIELDS = ("assign", "factor", "orig", "lo", "hi")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _same_prefix(a, b):
    assert torch.equal(a.valid, b.valid)
    k = int(b.valid.sum())
    for f in FIELDS:
        assert torch.equal(getattr(a, f)[:k], getattr(b, f)[:k]), f


def _db(seed=3, nv=30, ne=400):
    rng = np.random.default_rng(seed)
    return graph_db(rng.integers(0, nv, size=(ne, 2)))


@pytest.mark.parametrize("C", [1 << 8, 1 << 12])
@pytest.mark.parametrize("q", [cycle_query(5), star_query(3), bowtie_query()])
def test_expand_kernel_matches_plain_level_by_level(dev, q, C):
    from repro_torch.core.cached_frontier import CachedTrieJoin
    db = _db()
    td, order = engine.plan_query(q, db)
    eng = CachedTrieJoin(q, td, order, db, capacity=C, device=dev)
    F = eng.initial_frontier()
    for d in range(eng.n):
        a = eng.expand_kernel_args(d)
        kw = dict(d=d, g_ai=a["g_ai"], other_ais=a["other_ais"],
                  n_rows_g=a["n_rows_g"])
        Fc, nc = expand_cuda.expand(F, a["g_col"], a["g_rs"],
                                    a["other_cols"], **kw)
        Fp, np_ = expand_plain.expand_step(F, a["g_col"], a["g_rs"],
                                           a["other_cols"], **kw)
        assert int(nc) == int(np_)
        _same_prefix(Fc, Fp)
        F = Fp


EXPAND_KINDS = ("no-valid", "all-survive", "none-survive", "overflow")


def _expand_case(C, kind, dev):
    """A synthetic EXPAND(2) of a chunk of C rows, n = 3 columns, m = 3
    atoms: the guard (atom 0) has 4096 runs of 1-3 rows, candidate run k
    holding value 2k; each valid row's guard window spans one run (three
    for "overflow", so that `needed` = 3C > C); atoms 1 and 2 are searched
    over their whole sorted column, which holds every candidate value
    ("all-survive"), none of them ("none-survive", odd values only) or a
    random half ("overflow").  "no-valid" has no valid row."""
    rng = np.random.default_rng([C, EXPAND_KINDS.index(kind)])
    nruns = 4096
    rs = np.concatenate([[0], np.cumsum(rng.integers(1, 4, nruns - 1))])
    n_rows_g = int(rs[-1]) + int(rng.integers(1, 4))
    g_col = np.zeros(n_rows_g, np.int64)
    g_col[rs] = 2 * np.arange(nruns)
    width = 3 if kind == "overflow" else 1
    r = rng.integers(0, nruns - width + 1, C)
    ends = np.append(rs, n_rows_g)
    values = 2 * np.arange(nruns)
    if kind == "none-survive":
        values = values + 1
    elif kind == "overflow":
        values = np.sort(rng.choice(values, nruns // 2, replace=False))
    others = [torch.from_numpy(values.astype(np.int32)).to(dev)
              for _ in range(2)]
    lo = np.zeros((C, 3), np.int32)
    hi = np.full((C, 3), values.size, np.int32)
    lo[:, 0], hi[:, 0] = rs[r], ends[r + width]
    F = Frontier(
        assign=torch.from_numpy(rng.integers(0, 99, (C, 3)).astype(np.int32)),
        factor=torch.from_numpy(rng.integers(1, 9, C).astype(np.int64)),
        valid=torch.full((C,), kind != "no-valid"),
        orig=torch.arange(C, dtype=torch.int32),
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    F = Frontier(*(t.to(dev) for t in F))
    kw = dict(d=2, g_ai=0, other_ais=(1, 2), n_rows_g=n_rows_g)
    return (F, torch.from_numpy(g_col.astype(np.int32)).to(dev),
            torch.from_numpy(rs.astype(np.int32)).to(dev), others, kw)


@pytest.mark.parametrize("kind", EXPAND_KINDS)
@pytest.mark.parametrize("C", [1, 1000, 1 << 16, 1 << 25])
def test_expand_kernel_matches_plain_at_every_scale(dev, C, kind):
    """The single-pass EXPAND bit for bit against its plain version from
    one row to the static pass's 2^25, with no valid row, every slot a
    survivor, no survivor, and more candidates than slots."""
    F, g_col, g_rs, others, kw = _expand_case(C, kind, dev)
    Fc, nc = expand_cuda.expand(F, g_col, g_rs, others, **kw)
    Fp, np_ = expand_plain.expand_step(F, g_col, g_rs, others, **kw)
    torch.cuda.synchronize()
    assert int(nc) == int(np_)
    _same_prefix(Fc, Fp)
    k = int(Fp.valid.sum())
    want = {"no-valid": (0, 0), "all-survive": (C, C), "none-survive": (C, 0)}
    if kind in want:
        assert (int(np_), k) == want[kind]
    else:
        assert int(np_) == 3 * C and 0 < k <= C


def test_expand_launches_no_block_scan(dev):
    """``ctj_expand`` runs at most three kernels a call (two, besides its
    memsets), none of them the single-block scan, by the kernel names
    torch.profiler records."""
    from torch.profiler import ProfilerActivity, profile
    F, g_col, g_rs, others, kw = _expand_case(1 << 16, "overflow", dev)
    expand_cuda.expand(F, g_col, g_rs, others, **kw)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            expand_cuda.expand(F, g_col, g_rs, others, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if not n.startswith(("Memset", "Memcpy"))]
    assert kernels, f"the profiler recorded no kernel: {names}"
    assert len(kernels) <= 3 * calls, kernels
    assert not any("block_scan" in n for n in kernels), kernels
    assert all("expand" in n for n in kernels), kernels


def _fold_emit_call(entry, dev):
    """A call of one FOLD or EMIT entry point at C = 2^16 on seeded
    inputs: (the call, its kernels a call besides memsets, a fragment
    every kernel's name holds)."""
    C = 1 << 16
    if entry == "emit":
        P, active, _, _ = _fold_case(C, "mixed", dev)
        return (lambda: emit_cuda.pack(P.assign, active)), 1, "emit"
    if entry == "replay":
        P, active, ror, E = _fold_case(C, "mixed", dev)
        return (lambda: fold_cuda.replay(P, active, ror, E, d0=1, d1=3),
                2, "fold")
    if entry == "splice":
        P, hit, poff, plen, slab = _splice_inputs(C, C, dev)
        return (lambda: fold_cuda.splice(P, hit, poff, plen, slab, d0=1,
                                         d1=3), 2, "splice")
    args = _merged_inputs(C, C, dev, "truncated")
    return (lambda: fold_cuda.merged(*args, d0=1, d1=3)), 2, "merged"


@pytest.mark.parametrize("entry", ["replay", "splice", "merged", "emit"])
def test_fold_and_emit_launch_no_block_scan(dev, entry):
    """Each FOLD entry point runs at most two kernels a call and
    ``ctj_emit`` one, besides their memsets, none of them the single-block
    scan, by the kernel names torch.profiler records."""
    from torch.profiler import ProfilerActivity, profile
    call, per_call, fragment = _fold_emit_call(entry, dev)
    call()
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if not n.startswith(("Memset", "Memcpy"))]
    assert kernels, f"the profiler recorded no kernel: {names}"
    assert len(kernels) <= per_call * calls, kernels
    assert not any("block_scan" in n for n in kernels), kernels
    assert all(fragment in n for n in kernels), kernels


FOLD_KINDS = ("mixed", "no-active", "all-valid", "skew")


def _fold_case(C, kind, dev, n=5, m=3):
    """Parent and exit chunks of C rows for a replay-only FOLD, the exits
    sorted by representative (the sorted-exits invariant), and the
    active mask.  ``mixed``: half the parents valid, 70% of those active,
    reps = C / 8 representatives with a quarter of the rows as exits;
    ``no-active``: the same with no active parent; ``all-valid``: every
    parent valid and active, every exit row valid, one exit a
    representative (needed = C, every output slot valid); ``skew``: one
    active parent whose representative holds three quarters of the
    exits, so that its replay range covers many 1024-slot tiles, beside
    a few parents that replay a few rows."""
    rng = np.random.default_rng([C, FOLD_KINDS.index(kind)])
    reps = max(2, C // 8)
    ar = np.arange(C)

    def chunk(valid, orig):
        return Frontier(
            torch.from_numpy(rng.integers(0, 99, (C, n)).astype(np.int32)),
            torch.from_numpy(rng.integers(1, 9, C).astype(np.int64)),
            torch.from_numpy(valid), torch.from_numpy(orig.astype(np.int32)),
            torch.from_numpy(rng.integers(0, 99, (C, m)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 99, (C, m)).astype(np.int32)))

    if kind == "all-valid":
        P, E = chunk(ar >= 0, ar), chunk(ar >= 0, ar)
        active = ar >= 0
        ror = rng.permutation(C)
    elif kind == "skew":
        big = (3 * C) // 4
        eorig = np.concatenate([np.zeros(big, np.int64),
                                np.sort(rng.integers(1, reps, C - big))])
        P, E = chunk(ar < C // 2, ar), chunk(ar >= 0, eorig)
        active = (ar < C // 2) & (rng.random(C) < 0.05)
        ror = rng.integers(1, reps, C)
        active[C // 3] = True
        ror[C // 3] = 0
    else:
        eorig = np.full(C, reps - 1)
        eorig[:C // 4] = np.sort(rng.integers(0, reps, C // 4))
        P, E = chunk(ar < C // 2, ar), chunk(ar < C // 4, eorig)
        active = (ar < C // 2) & (rng.random(C) < 0.7) & (kind == "mixed")
        ror = rng.integers(0, reps, C)
    return (Frontier(*(t.to(dev) for t in P)),
            torch.from_numpy(active).to(dev),
            torch.from_numpy(ror.astype(np.int32)).to(dev),
            Frontier(*(t.to(dev) for t in E)))


@pytest.mark.parametrize("kind", FOLD_KINDS)
@pytest.mark.parametrize("C", [1, 1 << 8, 1000, 1025, 1 << 12, 1 << 16,
                               1 << 20])
def test_fold_and_emit_kernels_match_plain(dev, C, kind):
    """The replay-only FOLD and EMIT bit for bit against their plain
    versions from one row to 2^20 (tiles of 1024: one, a ragged last
    tile, many), with no active parent, every row valid, and one parent
    whose replay range spans many tiles; EMIT packs the active mask."""
    P, active, ror, E = _fold_case(C, kind, dev)
    Oc, sc = fold_cuda.replay(P, active, ror, E, d0=1, d1=3)
    Op, sp = fold_plain.replay(P, active, ror, E, d0=1, d1=3)
    torch.cuda.synchronize()
    assert torch.equal(sc, sp)
    _same_prefix(Oc, Op)
    needed = int(sp[0])
    if kind == "no-active":
        assert needed == 0
    if kind == "all-valid":
        assert needed == C and bool(Op.valid.all())
    if kind == "skew" and C >= 1 << 12:
        assert needed >= (3 * C) // 4 > 2 * 1024
    pc, kc = emit_cuda.pack(P.assign, active)
    pp, kp = emit_plain.pack(P.assign, active)
    torch.cuda.synchronize()
    assert int(kc) == int(kp) == int(active.sum())
    assert torch.equal(pc[:int(kp)], pp[:int(kp)])
    if kind == "all-valid":
        assert int(kp) == C


def _hub_db():
    """A hub whose candidate run alone exceeds a 2^8 chunk, so the
    executor splits oversized rows before EXPAND (as in
    ``test_torch_engine.py::test_oversized_rows_split_like_reference``)."""
    rng = np.random.default_rng(5)
    hub = np.stack([np.zeros(700, np.int64), np.arange(1, 701)], axis=1)
    return graph_db(np.concatenate([hub, rng.integers(0, 700, (300, 2))]))


ENGINE_CASES = [("path-4", path_query(4), "small"),
                ("cycle-4", cycle_query(4), "small"),
                ("bowtie", bowtie_query(), "small"),
                ("lollipop-3-2", lollipop_query(3, 2), "small"),
                ("star-3", star_query(3), "small"),
                ("hub-star-2", star_query(2), "hub")]
STATS = ["tier1_rows_collapsed"] + [
    f"tier2_{k}" for k in ("hits", "misses", "probes", "inserts",
                           "evictions", "resizes")]


@pytest.mark.parametrize("qname,q,which", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_engine_on_the_card_matches_cpu(dev, qname, q, which):
    """count and evaluate on the card equal the CPU run: counts, tuples in
    block order, tier counters.  The FOLD kernel relies on the executor's
    sorted-exits invariant, which the plain version (it sorts the exits
    itself) cannot see; this is where a broken invariant shows."""
    db = _db(nv=20, ne=300) if which == "small" else _hub_db()
    for fn in (engine.count, engine.evaluate):
        g = fn(q, db, capacity=1 << 8)
        c = fn(q, db, capacity=1 << 8, device="cpu")
        assert g.count == c.count
        if g.tuples is not None:
            np.testing.assert_array_equal(g.tuples, c.tuples)
            for op in ("fold", "emit"):
                assert (g.counters[f"{op}_calls_cuda"]
                        == c.counters[f"{op}_calls_torch"])
                assert g.counters[f"{op}_calls_torch"] == 0
        for k in STATS:
            assert g.counters.get(k, 0) == c.counters.get(k, 0), k
        assert g.counters["expand_calls_cuda"] > 0
        assert g.counters["expand_calls_torch"] == 0
        assert c.counters["expand_calls_cuda"] == 0


SPLICE_KINDS = ("overflow", "skew", "no-hit")


def _splice_inputs(C, seed, dev, n=5, m=3, w=3, slab_rows=1 << 17,
                   kind="overflow"):
    """A parent chunk and payload hits whose blocks are contiguous slab
    runs (the last slab row is the store's scratch row).  ``overflow``:
    about 1.25 C spliced rows in all, at least two (so the output is
    truncated to C); ``skew``: a hit every 16th row and one parent whose
    block fills half the chunk, or the whole slab where that is shorter
    (many 1024-slot tiles); ``no-hit``."""
    rng = np.random.default_rng(seed)
    hit = rng.random(C) < 0.5
    plen = np.where(hit, rng.integers(1, 5, C), 0).astype(np.int32)
    poff = np.where(hit, rng.integers(0, slab_rows - 8, C),
                    0).astype(np.int32)
    if kind == "overflow":
        hit[0], plen[0] = True, max(plen[0], 2)
    elif kind == "skew":
        hit &= np.arange(C) % 16 == 0
        hit[C // 2] = True
        plen[C // 2] = max(1, min(C // 2, slab_rows - 8))
        poff[C // 2] = 0
        plen[~hit], poff[~hit] = 0, 0
    else:
        hit[:], plen[:], poff[:] = False, 0, 0
    P = Frontier(
        torch.from_numpy(rng.integers(0, 99, (C, n)).astype(np.int32)),
        torch.from_numpy(rng.integers(1, 9, C).astype(np.int64)),
        torch.from_numpy(np.arange(C) < C // 2),
        torch.from_numpy(np.arange(C, dtype=np.int32)),
        torch.from_numpy(rng.integers(0, 99, (C, m)).astype(np.int32)),
        torch.from_numpy(rng.integers(0, 99, (C, m)).astype(np.int32)))
    slab = rng.integers(0, 1 << 20, (slab_rows + 1, w)).astype(np.int32)
    return (Frontier(*(t.to(dev) for t in P)),
            torch.from_numpy(hit).to(dev), torch.from_numpy(poff).to(dev),
            torch.from_numpy(plen).to(dev), torch.from_numpy(slab).to(dev))


@pytest.mark.parametrize("kind", SPLICE_KINDS)
@pytest.mark.parametrize("C", [1, 1000, 1025, 1 << 12, 1 << 16, 1 << 20])
def test_splice_kernel_matches_plain(dev, C, kind):
    P, hit, poff, plen, slab = _splice_inputs(C, C, dev, kind=kind)
    before = fold_cuda.splice_launches
    Oc, sc = fold_cuda.splice(P, hit, poff, plen, slab, d0=1, d1=3)
    Op, sp = fold_plain.splice(P, hit, poff, plen, slab, d0=1, d1=3)
    torch.cuda.synchronize()
    assert fold_cuda.splice_launches == before + 1
    assert torch.equal(sc, sp)
    n_spl = int(sp[1])
    if kind == "overflow":
        assert n_spl > C, "the case must overflow the chunk"
    elif kind == "skew":  # the big block, cut to the slab's length
        assert max(1, min(C // 2, (1 << 17) - 8)) <= n_spl <= C
    else:
        assert n_spl == 0 and not bool(Oc.valid.any())
    _same_prefix(Oc, Op)
    with pytest.raises(ValueError):  # a slab of the wrong width
        fold_cuda.splice(P, hit, poff, plen, slab[:, :2], d0=1, d1=3)


PAYLOAD = CacheConfig(policy="setassoc", assoc=4, slots=64,
                      cache_payloads=True, payload_rows=1 << 12)


@pytest.mark.parametrize("qname,q,which", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_payload_engine_on_the_card_matches_cpu(dev, qname, q, which):
    """Payload evaluation, cold then warm on one engine per device, and
    a stream on fresh engines: the card gives the CPU's tuples in block
    order and the same tier counters, with every splice on the kernel."""
    from repro_torch.core.cached_frontier import CachedTrieJoin
    db = _db(nv=20, ne=300) if which == "small" else _hub_db()
    td, order = engine.plan_query(q, db)
    engs = [CachedTrieJoin(q, td, order, db, capacity=1 << 8,
                           cache=PAYLOAD, device=d) for d in (dev, "cpu")]
    for run in ("cold", "warm"):
        g, c = (list(e.evaluate()) for e in engs)
        assert len(g) == len(c), run
        for a, b in zip(g, c):
            np.testing.assert_array_equal(a, b, err_msg=run)
        for k in STATS + ["tier2_replay_hits", "tier2_payload_flushes",
                          "tier2_payload_skips", "tier2_slab_rows"]:
            assert engs[0].stats[k] == engs[1].stats[k], (run, k)
    gs, cs = engs[0].stats, engs[1].stats
    for op in ("fold", "fold_splice", "emit"):
        assert gs[f"{op}_calls_cuda"] == cs[f"{op}_calls_torch"]
        assert gs[f"{op}_calls_torch"] == 0
    streams = [list(CachedTrieJoin(q, td, order, db, capacity=1 << 8,
                                   cache=PAYLOAD, device=d)
                    .evaluate_stream()) for d in (dev, "cpu")]
    assert len(streams[0]) == len(streams[1])
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)


def _merged_inputs(C, seed, dev, case, n=5, m=3, w=3, slab_rows=1 << 17):
    """A parent chunk, sorted exits (the sorted-exits invariant), miss
    parents that replay and hit parents with contiguous slab blocks.
    ``case``: ``fits`` (replay and splice fill about 0.75 C together),
    ``truncated`` (the replay fills half the chunk and the splice is cut
    short), ``replay-overflow`` (every exit valid: the replay alone needs
    about 2 C rows), ``no-replay`` or ``no-splice``."""
    rng = np.random.default_rng(seed)
    n_reps = C // 8
    n_exits = {"truncated": C // 4, "replay-overflow": C}.get(case, C // 8)
    P = _splice_inputs(C, seed, "cpu", n=n, m=m, w=w, slab_rows=16)[0]
    hit = P.valid.numpy() & (rng.random(C) < 0.5)
    active = P.valid.numpy() & ~hit
    if case == "no-replay":
        active[:] = False
    if case == "no-splice":
        hit[:] = False
    plen = np.where(hit, rng.integers(1, 3 if case != "truncated" else 9,
                                      C), 0).astype(np.int32)
    poff = np.where(hit, rng.integers(0, slab_rows - 8, C),
                    0).astype(np.int32)
    ror = rng.integers(0, n_reps, C).astype(np.int32)
    eorig = np.full(C, n_reps - 1, np.int32)
    eorig[:n_exits] = np.sort(rng.integers(0, n_reps, n_exits))
    E = P._replace(assign=torch.from_numpy(
        rng.integers(0, 99, (C, n)).astype(np.int32)),
        valid=torch.from_numpy(np.arange(C) < n_exits),
        orig=torch.from_numpy(eorig))
    slab = rng.integers(0, 1 << 20, (slab_rows + 1, w)).astype(np.int32)
    t = (torch.from_numpy(x).to(dev)
         for x in (active, ror, hit, poff, plen, slab))
    active, ror, hit, poff, plen, slab = t
    return (Frontier(*(x.to(dev) for x in P)), active, ror,
            Frontier(*(x.to(dev) for x in E)), hit, poff, plen, slab)


MERGED_CASES = ("fits", "truncated", "replay-overflow", "no-replay",
                "no-splice")


@pytest.mark.parametrize("case", MERGED_CASES)
@pytest.mark.parametrize("C,seed", [(1000, 5), (1025, 6), (1 << 12, 3),
                                    (1 << 16, 4), (1 << 20, 7)])
def test_merged_kernel_matches_plain(dev, C, seed, case):
    """The merged FOLD bit for bit against its plain version, its splice
    region starting at n1 = min(needed, C) (no tile boundary), with
    ``stats[2] = min(needed, C) + min(n_spliced, C)`` uncapped when the
    two overflow the chunk."""
    args = _merged_inputs(C, seed, dev, case)
    before = fold_cuda.merged_launches
    Oc, sc = fold_cuda.merged(*args, d0=1, d1=3)
    Op, sp = fold_plain.merged(*args, d0=1, d1=3)
    torch.cuda.synchronize()
    assert fold_cuda.merged_launches == before + 1
    assert torch.equal(sc, sp)
    needed, n_spl = int(sp[0]), int(sp[1])
    assert (needed > 0) == (case != "no-replay")
    assert (n_spl > 0) == (case != "no-splice")
    assert (needed + n_spl > C) == (case in ("truncated", "replay-overflow"))
    assert (needed > C) == (case == "replay-overflow")
    assert int(sp[2]) == min(needed, C) + min(n_spl, C)
    assert (int(sp[2]) > C) == (needed + n_spl > C)
    _same_prefix(Oc, Op)
    with pytest.raises(ValueError):  # a slab of the wrong width
        fold_cuda.merged(*args[:7], args[7][:, :2], d0=1, d1=3)


@pytest.mark.parametrize("q", [bowtie_query(), cycle_query(5),
                               path_query(5)], ids=["bowtie", "cycle5",
                                                    "path5"])
def test_static_engine_on_the_card_matches_cpu(dev, q):
    """StaticCLFTJ cold then warm, and a count pass, on the card and on
    the CPU: the same rows in the same order, stats and table planes, with
    every FOLD on a CUDA kernel (the 5-path also sorts an exit chunk)."""
    from repro_torch.core.distributed import StaticCLFTJ
    db = _db(nv=16, ne=120)
    td, order = engine.plan_query(q, db)
    engs = [StaticCLFTJ(q, td, order, db, capacity=1 << 15, cache=PAYLOAD,
                        device=d) for d in (dev, "cpu")]
    tables = [None, None]
    for run in ("cold", "warm"):
        (rg, sg, tables[0]), (rc_, sc_, tables[1]) = (
            e.evaluate_static(t) for e, t in zip(engs, tables))
        np.testing.assert_array_equal(rg, rc_, err_msg=run)
        assert sg == sc_ and not sg["overflow"], run
        for node in tables[1]:
            for a, b in zip(tables[0][node], tables[1][node]):
                assert torch.equal(a.cpu(), b), (run, node)
    assert sg["tier2_replay_hits"] > 0
    gs, cs = engs[0].stats, engs[1].stats
    for op in ("expand", "fold", "fold_merged", "emit"):
        assert gs[f"{op}_calls_cuda"] == cs[f"{op}_calls_torch"] > 0, op
        assert gs[f"{op}_calls_torch"] == 0, op
    assert gs["fold_sorted_exits"] == cs["fold_sorted_exits"]
    counts = [e.count_fn()(e.initial_frontier()) for e in engs]
    assert [int(x) for x in counts[0]] == [int(x) for x in counts[1]]


def _bound_inputs(M, n_runs, seed, dev, windows):
    """M queries over a column sorted within each of ``n_runs`` runs, as a
    trie level is.  ``windows``: "runs" (each query's window one whole
    run), "inside" (a sub-window of a run), "clipped" (a run's start to
    past the column's end) or "empty" (lo >= hi, some lo past the end)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 40, n_runs)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    col = np.concatenate([np.sort(rng.integers(0, 5000, k)) for k in lens])
    n = col.size
    r = rng.integers(0, n_runs, M)
    lo, hi = starts[r], starts[r] + lens[r]
    if windows == "inside":
        lo = lo + rng.integers(0, lens[r])
        hi = np.minimum(hi, lo + rng.integers(0, lens[r] + 1))
    elif windows == "clipped":
        hi = np.full(M, n + 7)
        lo = starts[np.full(M, n_runs - 1)]
    elif windows == "empty":
        lo = rng.integers(0, n + 10, M)
        hi = lo - rng.integers(0, 3, M)
    v = rng.integers(-2, 5003, M)
    return [torch.from_numpy(np.asarray(a, np.int32)).to(dev)
            for a in (col, v, lo, hi)]


@pytest.mark.parametrize("windows", ["runs", "inside", "clipped", "empty"])
@pytest.mark.parametrize("M,n_runs,seed", [(1 << 8, 7, 0), (1 << 16, 5000, 1)])
def test_bound_kernel_matches_plain(dev, M, n_runs, seed, windows):
    col, v, lo, hi = _bound_inputs(M, n_runs, seed, dev, windows)
    for strict in (True, False):
        before = bound_cuda.launches
        got = bound_cuda.bound(col, v, lo, hi, strict=strict)
        want = bound_plain.bound(col, v, lo, hi, strict=strict)
        torch.cuda.synchronize()
        assert bound_cuda.launches == before + 1
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)


def test_bound_kernel_refuses_other_dtypes_and_skips_empty_columns(dev):
    col, v, lo, hi = _bound_inputs(64, 4, 2, dev, "runs")
    with pytest.raises(ValueError, match="kernel takes"):
        bound_cuda.bound(col.long(), v, lo, hi, strict=True)
    with pytest.raises(ValueError, match="kernel takes"):
        bound_cuda.bound(col, v, lo.long(), hi, strict=True)
    before = bound_cuda.launches
    empty = col[:0]
    assert bound_cuda.bound(empty, v, lo, hi, strict=False) is lo
    assert bound_cuda.launches == before


def _atoms_inputs(C, n_atoms, seed, dev, kind):
    """C slots of a chain EXPAND's membership test over ``n_atoms`` atoms,
    atom k on lo/hi column k + 1 (column 0 stands for the guard's, which
    the test must leave alone).  Every atom's column has the same 64 runs,
    each sorted; a live slot's window is one run, the same in every atom,
    and its value mostly one of atom 0's values in that run (each atom
    redraws a tenth of its values, so a slot survives some atoms and not
    others).  ``kind``: "runs"; "skewed" (each column sorted as a whole,
    and one slot in 64 searching a window over the whole column and past
    its end); "dups" (values 0-15: long runs of equal values); "dead"
    (``ok`` all False); "empty" (the middle atom's column empty)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 40, 64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    top = 16 if kind == "dups" else 5000
    base = np.concatenate([rng.integers(0, top, k) for k in lens])
    cols = []
    for _ in range(n_atoms):
        col = np.where(rng.random(base.size) < 0.1,
                       rng.integers(0, top, base.size), base)
        col = (np.sort(col) if kind == "skewed" else np.concatenate(
            [np.sort(col[a:a + k]) for a, k in zip(starts, lens)]))
        cols.append(col)
    if kind == "empty":
        cols[n_atoms // 2] = cols[n_atoms // 2][:0]
    n = base.size
    r = rng.integers(0, 64, C)
    lo2 = np.tile(rng.integers(0, n, (C, 1)), (1, n_atoms + 1))
    hi2 = lo2 + rng.integers(0, 9, (C, n_atoms + 1))
    lo2[:, 1:] = starts[r][:, None]
    hi2[:, 1:] = (starts[r] + lens[r])[:, None]
    if kind == "skewed":
        lo2[::64, 1:], hi2[::64, 1:] = 0, n + 5
    pick = starts[r] + rng.integers(0, lens[r])
    values = np.where(rng.random(C) < 0.7, cols[0][pick],
                      rng.integers(-2, top + 3, C))
    ok = rng.random(C) < (0 if kind == "dead" else 0.75)
    i32 = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
           for a in (values, lo2, hi2)]
    return ([torch.from_numpy(c.astype(np.int32)).to(dev) for c in cols],
            tuple(range(1, n_atoms + 1)), i32[0],
            torch.from_numpy(ok).to(dev), i32[1], i32[2])


ATOM_CASES = [("runs", 1), ("runs", 3), ("skewed", 3), ("dups", 3),
              ("dead", 3), ("runs", 2 * bound_cuda.MAX_ATOMS + 3),
              ("empty", 2 * bound_cuda.MAX_ATOMS + 3)]


@pytest.mark.parametrize("kind,n_atoms", ATOM_CASES,
                         ids=[f"{k}-{a}" for k, a in ATOM_CASES])
@pytest.mark.parametrize("C,seed", [(1 << 8, 0), (1 << 16, 1)])
def test_bound_atoms_kernel_matches_plain(dev, C, seed, kind, n_atoms):
    """``ctj_bound_atoms`` against ``plain.bound_atoms``: ``ok`` on every
    slot, the windows on every slot whose final ``ok`` is set, the guard's
    column untouched; with one group of atoms, no window written on a
    slot that an atom rejects; one launch per group of ``MAX_ATOMS``
    columns, none when a column is empty."""
    cols, ais, values, ok, lo2, hi2 = _atoms_inputs(C, n_atoms, seed, dev,
                                                    kind)
    got, want = ([t.clone() for t in (ok, lo2, hi2)] for _ in range(2))
    before = bound_cuda.atoms_launches
    bound_cuda.bound_atoms(bound_cuda.Atoms(cols, ais), values, *got)
    bound_plain.bound_atoms(cols, ais, values, *want)
    torch.cuda.synchronize()
    groups = (0 if kind == "empty" else
              -(-len(cols) // bound_cuda.MAX_ATOMS))
    assert bound_cuda.atoms_launches - before == groups
    keep = want[0]
    assert torch.equal(got[0], keep)
    assert torch.equal(got[1][keep], want[1][keep])
    assert torch.equal(got[2][keep], want[2][keep])
    assert torch.equal(got[1][:, 0], lo2[:, 0])
    assert torch.equal(got[2][:, 0], hi2[:, 0])
    if groups <= 1:
        assert torch.equal(got[1][~keep], lo2[~keep])
        assert torch.equal(got[2][~keep], hi2[~keep])
    assert bool(keep.any()) == (kind not in ("dead", "empty"))


def test_bound_atoms_wrapper_refuses_other_dtypes_and_devices(dev):
    cols, ais, values, ok, lo2, hi2 = _atoms_inputs(64, 2, 3, dev, "runs")
    atoms = bound_cuda.Atoms(cols, ais)
    with pytest.raises(ValueError, match="kernel takes"):
        bound_cuda.Atoms([cols[0].long()], (1,))
    with pytest.raises(ValueError, match="kernel runs on"):
        bound_cuda.Atoms([cols[0].cpu()], (1,))
    before = bound_cuda.atoms_launches
    bad = {"values": (values.long(), ok, lo2, hi2),
           "ok": (values, ok.to(torch.uint8), lo2, hi2),
           "lo2": (values, ok, lo2.long(), hi2),
           "hi2": (values, ok, lo2, hi2.t().contiguous().t()),
           "device": (values.cpu(), ok.cpu(), lo2.cpu(), hi2.cpu())}
    for what, args in bad.items():
        with pytest.raises(ValueError):
            bound_cuda.bound_atoms(atoms, *args)
    assert bound_cuda.atoms_launches == before


def test_bound_atoms_on_a_cuda_chunk_never_runs_plain(dev, monkeypatch):
    """registry.bound_atoms(impl="leapfrog") on a CUDA chunk launches the
    kernel over the columns' prebuilt layout, refuses a call without it,
    and never reaches the plain version."""
    from repro_torch.kernels import registry

    def refuse(*args, **kw):
        raise AssertionError("a CUDA chunk reached plain.bound_atoms")

    monkeypatch.setattr(bound_plain, "bound_atoms", refuse)
    cols, ais, values, ok, lo2, hi2 = _atoms_inputs(256, 3, 4, dev, "runs")
    before = bound_cuda.atoms_launches
    with pytest.raises(ValueError, match="needs the columns"):
        registry.bound_atoms(cols, ais, values, ok, lo2, hi2,
                             impl="leapfrog")
    registry.bound_atoms(cols, ais, values, ok, lo2, hi2, impl="leapfrog",
                         atoms=bound_cuda.Atoms(cols, ais))
    torch.cuda.synchronize()
    assert bound_cuda.atoms_launches == before + 1 and bool(ok.any())


@pytest.mark.parametrize("qname,q,which", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_chain_leapfrog_engine_on_the_card_matches_cpu(dev, qname, q, which):
    """The chain EXPAND with the leapfrog kernel on the card equals the CPU
    run (dense count) and the fused path: counts, tuples in block order,
    tier counters; every bound call launched ``ctj_bound_atoms``."""
    db = _db(nv=20, ne=300) if which == "small" else _hub_db()
    kw = dict(capacity=1 << 8, impl="leapfrog", expand_kernel="chain")
    for fn in (engine.count, engine.evaluate):
        before = bound_cuda.atoms_launches, bound_cuda.launches
        g = fn(q, db, **kw)
        launched = bound_cuda.atoms_launches - before[0]
        assert bound_cuda.launches == before[1]  # the chain runs no ctj_bound
        c = fn(q, db, device="cpu", **kw)
        f = fn(q, db, capacity=1 << 8)
        assert g.count == c.count == f.count
        if g.tuples is not None:
            np.testing.assert_array_equal(g.tuples, c.tuples)
            np.testing.assert_array_equal(g.tuples, f.tuples)
        for k in STATS:
            assert g.counters.get(k, 0) == c.counters.get(k, 0), k
        assert g.counters["expand_calls_chain"] == c.counters[
            "expand_calls_chain"] == f.counters["expand_calls_cuda"] > 0
        assert g.counters["expand_calls_cuda"] == 0
        assert g.counters["bound_calls_cuda"] == launched == c.counters[
            "bound_calls_torch"]
        assert g.counters["bound_calls_torch"] == 0



FLASH_CASES = [
    # b, t, s, h, hkv, dh, causal, window, q_offset: the reference sweep
    (1, 8, 8, 4, 2, 16, True, None, 0),
    (2, 16, 16, 4, 4, 32, True, None, 0),
    (1, 8, 24, 4, 1, 16, True, None, 16),
    (2, 32, 32, 6, 2, 16, True, 8, 0),
    (1, 16, 16, 4, 2, 16, False, None, 0),
    (2, 1, 40, 8, 2, 64, True, None, 39),
    (1, 24, 24, 2, 2, 128, True, 16, 0),
    # qwen2.5-3b's prefill, a ragged length, a chunked prefill, stablelm's
    # head dim, a window spanning several tiles, Dh = 256
    (4, 2048, 2048, 16, 2, 128, True, None, 0),
    (1, 1000, 1000, 16, 2, 128, True, None, 0),
    (1, 1024, 2048, 16, 2, 128, True, None, 1024),
    (1, 300, 300, 32, 8, 160, True, None, 0),
    (1, 300, 300, 8, 2, 64, True, 100, 0),
    (1, 100, 130, 4, 1, 256, False, None, 0),
    # the block families' shapes at full width: recurrentgemma's local
    # prefill (twice its window), llama-3.2-vision's cross prefill and
    # cross decode step, whisper's encoder and cross decode step
    (2, 4096, 4096, 10, 1, 256, True, 2048, 0),
    (1, 2048, 1601, 64, 8, 128, False, None, 0),
    (1, 1, 1601, 64, 8, 128, False, None, 0),
    (4, 1500, 1500, 6, 6, 64, False, None, 0),
    (4, 1, 1500, 6, 6, 64, False, None, 0),
    # qwen2.5-3b's attention on one rank of a (data 2, model 2) mesh: a
    # microbatch row, 8 query heads over 1 KV head; and phi3.5-moe's
    # there: two rows in one microbatch, 16 query heads over 4 KV heads
    (1, 2048, 2048, 8, 1, 128, True, None, 0),
    (2, 2048, 2048, 16, 4, 128, True, None, 0),
    # qwen3-moe-235b-a22b's prefill served under MOE_SERVE_RULES on a
    # (data 2, model 2) mesh: one rank's row, 32 query heads over 2 KV
    # heads; and one process's, both rows and one, 64 over 4
    (1, 2048, 2048, 32, 2, 128, True, None, 0),
    (2, 2048, 2048, 64, 4, 128, True, None, 0),
    (1, 2048, 2048, 64, 4, 128, True, None, 0),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(case, dtype, dev):
    rng = np.random.default_rng(list(case[:6]) + [case[8]])
    b, t, s, h, hkv, dh = case[:6]
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 .to(dev, dtype)
                 for shape in ((b, t, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, case, dtype):
    q, k, v = _flash_inputs(case, dtype, dev)
    kw = dict(causal=case[6], window=case[7], q_offset=case[8])
    before = flash_cuda.launches
    got = flash_cuda.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 1
    want = flash_plain.flash_attention(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("dh", flash_cuda.HEAD_DIMS)
def test_flash_kernel_at_every_head_dim(dev, dh, window, dtype):
    """Every head dim the kernel takes, on a ragged shape: T = 77 (no
    whole 64-row tile), G = 3 query heads a KV head (T·G = 231, odd), a
    chunked prefill (q_offset 20) over S = 97 keys (no whole 64- or
    32-key tile), causal, with and without a window."""
    case = (2, 77, 97, 3, 1, dh, True, window, 20)
    q, k, v = _flash_inputs(case, dtype, dev)
    kw = dict(causal=True, window=window, q_offset=20)
    got = flash_cuda.flash_attention(q, k, v, **kw)
    want = flash_plain.flash_attention(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _flash_inputs((1, 8, 8, 4, 2, 16, True, None, 0),
                            torch.float32, dev)
    before = flash_cuda.launches
    with pytest.raises(ValueError, match="kernel takes"):
        flash_cuda.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="kernel takes"):
        flash_cuda.flash_attention(q, k.bfloat16(), v)
    wide = torch.zeros(1, 8, 4, 96, device=dev)
    kv = torch.zeros(1, 8, 2, 96, device=dev)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_cuda.flash_attention(wide, kv, kv)
    with pytest.raises(ValueError, match="not contiguous"):
        flash_cuda.flash_attention(q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), k, v)
    assert flash_cuda.launches == before


GRAD_CASES = [FLASH_CASES[3], FLASH_CASES[6],
              (2, 512, 512, 16, 2, 128, True, None, 0),
              (1, 300, 300, 8, 2, 64, True, 100, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_fused_attention_gradients_match_chain(dev, case, dtype):
    """``impl="fused"`` on CUDA q, k, v that require grad: one kernel
    launch in the forward pass (none in backward, which recomputes the
    plain path once, ``backward_calls``), the kernel's output within the
    sweep's tolerance of the chain's, and q, k, v gradients equal to
    ``impl="chain"``'s within the same tolerance (both differentiate the
    same plain blocked softmax on the same inputs)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    kw = dict(causal=case[6], window=case[7], q_offset=case[8])
    base = _flash_inputs(case, dtype, dev)
    w = torch.randn(base[0].shape, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, dtype=dtype)
    outs, grads = [], []
    for impl in ("fused", "chain"):
        q, k, v = (x.clone().requires_grad_() for x in base)
        before = (flash_cuda.launches, flash_cuda.backward_calls)
        out = flash_ops.flash_attention(q, k, v, impl=impl, **kw)
        grads.append(torch.autograd.grad((out * w).float().sum(), (q, k, v)))
        torch.cuda.synchronize()
        n = int(impl == "fused")
        assert (flash_cuda.launches, flash_cuda.backward_calls) == (
            before[0] + n, before[1] + n)
        assert out.requires_grad
        outs.append(out.detach().float())
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(outs[0], outs[1], rtol=tol, atol=tol)
    for what, a, b in zip("qkv", *grads):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                   msg=f"d{what}")


def test_model_loss_and_train_step_on_the_card_match_cpu(dev):
    """qwen2.5-3b at smoke size in fp32: ``Model.loss`` on the card (the
    kernel in every layer's forward and again in its remat recompute,
    2 launches a layer; the plain path once a layer in backward) gives
    the CPU model's loss and gradients within 1e-4; a train step with
    microbatches=2 launches 2 x 2 a layer and gives the CPU step's
    metrics and parameters within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    cfg = dataclasses.replace(get_arch("qwen2.5-3b-smoke"),
                              dtype_compute="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)),
             "targets": rng.integers(0, cfg.vocab, (4, 16))}
    n = cfg.n_layers
    before = (flash_cuda.launches, flash_cuda.backward_calls)
    losses = []
    for model in (gpu, cpu):
        loss, _ = model.loss(batch)
        loss.backward()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    assert (flash_cuda.launches, flash_cuda.backward_calls) == (
        before[0] + 2 * n, before[1] + n)
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=1e-4,
                                   atol=1e-6, msg=name)
    metrics = []
    for model in (gpu, cpu):
        model.zero_grad(set_to_none=True)
        before = flash_cuda.launches
        step = make_train_step(model, TrainConfig(microbatches=2))
        _, m = step(init_train_state(model), batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if model is gpu:
            torch.cuda.synchronize()
            assert flash_cuda.launches == before + 2 * 2 * n
    for key in metrics[1]:
        assert metrics[0][key] == pytest.approx(metrics[1][key], rel=1e-4)
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(pg.detach().cpu(), pc.detach(), rtol=1e-4,
                                   atol=1e-6, msg=name)


def test_lm_on_the_card_matches_cpu(dev):
    """qwen2.5-3b at smoke size in fp32: the card's prefill (the kernel,
    one launch a layer), decode and greedy tokens equal the CPU model's
    (plain attention) on the same weights, within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models.kvcache import pad_caches
    from repro_torch.train.serve_step import greedy_generate
    cfg = dataclasses.replace(get_arch("qwen2.5-3b-smoke"),
                              dtype_compute="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    before = flash_cuda.launches
    lg, caches = gpu.prefill({"tokens": toks[:, :6]})
    assert flash_cuda.launches == before + cfg.n_layers
    want, want_c = cpu.prefill({"tokens": toks[:, :6]})
    torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = pad_caches(cfg, caches, 6)
    want_c = pad_caches(cfg, want_c, 6)
    for i in range(6, 12):
        lg, caches = gpu.decode(caches, toks[:, i:i + 1], i)
        want, want_c = cpu.decode(want_c, toks[:, i:i + 1], i)
        torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
    assert flash_cuda.launches == before + cfg.n_layers
    np.testing.assert_array_equal(
        greedy_generate(gpu, {"tokens": toks}, 5).numpy(),
        greedy_generate(cpu, {"tokens": toks}, 5).numpy())


def _chip_smoke():
    """The root ``chip_smoke.py`` as a module (its seeded kernel inputs)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["fold_replay", "fold_merged", "fold_splice",
                                  "emit"])
def test_fold_and_emit_chains_on_the_card_match_kernels(dev, name):
    """The FOLD and EMIT op chains on CUDA tensors give the kernels' valid
    prefix and stats, bit for bit, on ``chip_smoke.kernel_inputs``' seeded
    chunks at C = 2^16 on the ca-GrQc-scale graph's plan (the splice on
    this file's seeded payload hits), and launch no kernel of their own."""
    from repro_torch.kernels.emit import chain as emit_chain
    from repro_torch.kernels.fold import chain as fold_chain
    cs = _chip_smoke()
    eng, _ = cs.cycle_engine(cs.grqc_db(), dev)
    C = 1 << 16
    before = (fold_cuda.launches, fold_cuda.splice_launches,
              fold_cuda.merged_launches, emit_cuda.launches)
    if name == "emit":
        assign, valid = cs.kernel_inputs("emit", eng, dev, C)
        pc, kc = emit_chain.pack(assign, valid)
        assert (fold_cuda.launches, fold_cuda.splice_launches,
                fold_cuda.merged_launches, emit_cuda.launches) == before
        pk, kk = emit_cuda.pack(assign, valid)
        assert pc.is_cuda and int(kc) == int(kk) > 0
        assert torch.equal(pc[:int(kk)], pk[:int(kk)])
        return
    if name == "fold_replay":
        P, active, ror, E, d0, d1 = cs.kernel_inputs(name, eng, dev, C)
        args, replay, splice = (P, active, ror, E), True, False
        kernel = fold_cuda.replay
    elif name == "fold_merged":
        args, d0, d1 = cs.kernel_inputs(name, eng, dev, C)
        replay, splice, kernel = True, True, fold_cuda.merged
    else:
        args, d0, d1 = _splice_inputs(C, 7, dev), 1, 3
        replay, splice, kernel = False, True, fold_cuda.splice
    Fc, sc = fold_chain.build(d0=d0, d1=d1, with_replay=replay,
                              with_splice=splice)(*args)
    assert (fold_cuda.launches, fold_cuda.splice_launches,
            fold_cuda.merged_launches, emit_cuda.launches) == before
    Fk, sk = kernel(*args, d0=d0, d1=d1)
    assert Fc.assign.is_cuda and torch.equal(sc, sk)
    _same_prefix(Fc, Fk)


def test_chain_evaluate_launches_no_fold_or_emit_kernel(dev):
    """``fold_kernel="chain", emit_kernel="chain"`` on the card: the rows
    of the fused run in the same order, EXPAND still on its kernel, and
    not one FOLD or EMIT kernel launched (the executor counts the chains'
    calls as ``*_calls_chain``)."""
    db = _db(nv=20, ne=300)
    for q in (bowtie_query(), cycle_query(4)):
        fused = engine.evaluate(q, db, capacity=1 << 8,
                                cache=CacheConfig(slots=64,
                                                  cache_payloads=True))
        before = (fold_cuda.launches, fold_cuda.splice_launches,
                  emit_cuda.launches, expand_cuda.launches)
        chain = engine.evaluate(q, db, capacity=1 << 8,
                                cache=CacheConfig(slots=64,
                                                  cache_payloads=True),
                                fold_kernel="chain", emit_kernel="chain")
        after = (fold_cuda.launches, fold_cuda.splice_launches,
                 emit_cuda.launches, expand_cuda.launches)
        np.testing.assert_array_equal(chain.tuples, fused.tuples)
        assert after[:3] == before[:3]
        assert after[3] - before[3] == chain.counters["expand_calls_cuda"] > 0
        c = chain.counters
        assert c["fold_calls_chain"] == fused.counters["fold_calls_cuda"] > 0
        assert c["emit_calls_chain"] == fused.counters["emit_calls_cuda"] > 0
        assert c["fold_calls_cuda"] == c["emit_calls_cuda"] == 0


FAMILY_NAMES = ["recurrentgemma-2b", "qwen3-moe-235b-a22b",
                "phi3.5-moe-42b-a6.6b", "llama-3.2-vision-90b", "rwkv6-7b",
                "whisper-tiny"]


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_block_families_on_the_card_match_cpu(dev, name):
    """Each block family at smoke size in fp32 (window 8, so the ring
    wraps; capacity_factor 8, so nothing drops): the full forward, the
    prefill and six decode steps on the card (the kernel in every
    attention of a prefill and in each cross attention of a step) equal
    the CPU model's within 1e-4; the flash launches are the config's
    attention layers."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import pad_caches
    cfg = dataclasses.replace(get_arch(name + "-smoke"),
                              dtype_compute="float32", capacity_factor=8.0,
                              window=8 if "gemma" in name else None)
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 18))}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_decoder:
        batch["audio_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    kinds = cfg.layer_kinds()
    per_prefill = sum(k != "rglru" and k != "rwkv" for k in kinds) + \
        kinds.count("dec") + cfg.n_encoder_layers
    per_step = kinds.count("cross") + kinds.count("dec")
    with torch.no_grad():
        want, want_aux = T.forward(cfg, cpu, cpu._inputs(batch))
        before = flash_cuda.launches
        got, aux = T.forward(cfg, gpu, gpu._inputs(batch))
        torch.cuda.synchronize()
        assert flash_cuda.launches == before + per_prefill
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-7)
    prompt = dict(batch, tokens=batch["tokens"][:, :12])
    runs = []
    for model in (gpu, cpu):
        before = flash_cuda.launches
        lg, caches = model.prefill(prompt)
        caches = pad_caches(cfg, caches, 6)
        steps = [lg]
        for i in range(12, 18):
            lg, caches = model.decode(caches, batch["tokens"][:, i:i + 1], i)
            steps.append(lg)
        runs.append((torch.stack(steps, 1).cpu(), caches,
                     flash_cuda.launches - before))
    assert runs[0][2] == per_prefill + 6 * per_step and runs[1][2] == 0
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-4, atol=1e-4)
    for c_gpu, c_cpu in zip(runs[0][1], runs[1][1]):
        for key in c_cpu:
            torch.testing.assert_close(c_gpu[key].cpu().float(),
                                       c_cpu[key].float(), rtol=2 ** -7,
                                       atol=1e-4, msg=key)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_local_heads_matches_the_whole_kernel(dev, dtype):
    """The kernel through the mesh boundary (``ops._on_local_heads``), rank
    by rank of a (1, m) mesh on a fake group: each rank's output and
    gradients against the plain version on every head at once, with the
    GQA cases whose KV heads do not divide the model axis (the flash
    tolerance)."""
    from repro_torch.kernels import cudalib
    from test_torch_mesh import HEAD_CASES, local_heads_check
    cudalib.load()
    before = flash_cuda.launches
    for case in HEAD_CASES:
        local_heads_check(dev, case, dtype,
                          2e-5 if dtype == torch.float32 else 2e-2)
    assert flash_cuda.launches - before == sum(
        case[-1] for case in HEAD_CASES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_on_local_experts_matches_the_whole_layer(dev, dtype):
    """The MoE layer over a (1, 2) mesh on the card, rank by rank of a
    fake group (``test_torch_mesh.local_experts_check``): each rank's 2
    of 4 experts, summed over the ranks, give the whole layer's output
    and its x and router gradients, each rank's expert gradients the
    whole layer's on its experts (fp32 1e-5; bf16 3e-2: the ranks' bf16
    partial outputs add in another order than the whole layer's)."""
    from test_torch_mesh import local_experts_check
    local_experts_check(dev, dtype, 1e-5 if dtype == torch.float32
                        else 3e-2)


def test_probe_flops_match_a_live_count(dev):
    """qwen2.5-3b at smoke size (bf16, remat "full") with 4 layers: the
    cost probe's FLOPs of a train step (two groups extrapolated, meta
    tensors, the flash kernel by formula) equal FlopCounterMode's count
    of the same step on the card plus the kernel's forward formula at
    each launch (the kernel is a ctypes call the counter cannot see; its
    backward is the plain path, which it counts) within 1%."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import costprobe
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.models import Model
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    cfg = dataclasses.replace(get_arch("qwen2.5-3b-smoke"), n_layers=4)
    case = ShapeCase("t", "train", 256, 4)
    probe = costprobe.probe_costs(cfg, case, None, lambda c, cs, m:
                                  costprobe.cell_costs(c, cs, m,
                                                       microbatches=1))
    model = Model(cfg, device=dev)
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab, (case.batch, case.seq))
             for k in ("tokens", "targets")}
    step = make_train_step(model, TrainConfig(microbatches=2))
    state = init_train_state(model)
    with costprobe.live_count() as live:
        step(state, batch)
        torch.cuda.synchronize()
    assert live["kernel_flops"] > 0 and live["launches"] > 0
    assert abs(probe["flops"] / live["flops"] - 1) <= 0.01, \
        (probe["flops"], live)


TIER2_CHUNKS = ("sparse-prefix", "dense", "one-set", "dup-keys", "prefilled")


def _tier2_inputs(chunk, policy, pay, seed):
    """numpy inputs of one insert and the probe after it: the table (S, W)
    planes, the chunk's rows and, with ``pay``, the payload planes.

    * ``sparse-prefix``: C = 2^22, the first 2% of rows live (as the
      static pass offers its representatives), the rest garbage;
    * ``dense``: C = 2^16, 90% live, four keys a slot;
    * ``one-set``: every key hashes to one set of a full table, so every
      round admits one row there and evicts one;
    * ``dup-keys``: C = 2^16 keys from 500 values;
    * ``prefilled``: a nearly full table whose residents share the
      batch's key range (blocked, refreshed and evicted rows).

    The probe's rows are the chunk's keys or misses (key + 1), 80%
    active."""
    from repro_torch.kernels.tier2 import plain as tier2_plain
    rng = np.random.default_rng(seed)
    W = 1 if policy == "direct" else 8
    S, C, key_range, filled = 1 << 12, 1 << 16, 1 << 40, 0.0
    if chunk == "sparse-prefix":
        S, C = 1 << 16, 1 << 22
    elif chunk == "one-set":
        S, C, filled = 64, 4096, 1.0
    elif chunk == "dup-keys":
        key_range = 500
    elif chunk == "prefilled":
        key_range, filled = 1 << 15, 0.9
    keys = rng.integers(-key_range, key_range, C)
    if chunk == "one-set":
        cand = rng.integers(-(1 << 62), 1 << 62, 1 << 20)
        sets = tier2_plain.hash_sets(torch.from_numpy(cand), S).numpy()
        keys = cand[sets == 3][:C]
        assert keys.shape[0] == C
    active = (np.arange(C) < C // 50 if chunk == "sparse-prefix"
              else rng.random(C) < 0.9)
    table = [rng.integers(-key_range, key_range, (S, W)),
             rng.integers(0, 1000, (S, W)), rng.random((S, W)) < filled,
             rng.integers(0, 6, (S, W)).astype(np.int32),
             rng.integers(1, 100, (S, W))]
    rows = [keys, rng.integers(0, 1000, C), rng.integers(1, 100, C), active]
    pays = None
    if pay:
        pays = [rng.integers(0, 1 << 12, (S, W)).astype(np.int32),
                rng.integers(-1, 6, (S, W)).astype(np.int32),
                rng.integers(0, 1 << 12, C).astype(np.int32),
                rng.integers(-1, 6, C).astype(np.int32)]
    qkeys = np.where(rng.random(C) < 0.5, keys, keys + 1)
    return table, rows, pays, (qkeys, rng.random(C) < 0.8)


@pytest.mark.parametrize("chunk", TIER2_CHUNKS)
@pytest.mark.parametrize("pay", [False, True], ids=["count", "payload"])
@pytest.mark.parametrize("policy", ["direct", "setassoc", "costaware"])
def test_tier2_kernels_match_plain(dev, policy, pay, chunk):
    """``ctj_tier2_insert`` and ``ctj_tier2_probe`` (through
    ``cache._insert``, ``_probe`` and ``_probe_payload`` on CUDA chunks)
    against the plain twins on the same inputs on the CPU: every table
    plane, the admit and evict counts, and the probe's hits, values (or
    block offsets and lengths) and stamps, equal exactly."""
    from repro_torch.core import cache as cache_mod
    from repro_torch.kernels.tier2 import cuda as tier2_cuda
    from repro_torch.kernels.tier2 import plain as tier2_plain
    table, rows, pays, (qkeys, qactive) = _tier2_inputs(
        chunk, policy, pay, seed=len(chunk) * 7 + pay)
    W = table[0].shape[1]
    kw = dict(policy=policy, rounds=min(W, 8))
    t = [torch.from_numpy(a) for a in table]
    r = [torch.from_numpy(a) for a in rows]
    p = None if pays is None else [torch.from_numpy(a) for a in pays]
    on = lambda xs: None if xs is None else [x.to(dev) for x in xs]  # noqa
    before = (tier2_cuda.insert_launches, tier2_cuda.probe_launches)
    got = cache_mod._insert(*on(t), *on(r), 7, pay=on(p), **kw)
    want = tier2_plain.insert(*t, *r, 7, pay=p, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), i
    n_admit, n_evict = int(want[-2]), int(want[-1])
    assert n_admit > 0
    if chunk in ("one-set", "prefilled"):
        assert n_evict > 0
    if chunk == "one-set":
        assert n_admit == n_evict == min(W, 8)  # one a round
    # the probe's rows: the table's residents first, then the chunk's
    # keys and misses
    tk, tv, tu, ts = want[:4]
    resident = tk[tu][:qkeys.shape[0]].numpy()
    qkeys[:resident.shape[0]] = resident
    q = [torch.from_numpy(a) for a in (qkeys, qactive)]
    gp = cache_mod._probe(*on([tk, tv, tu, ts]), *on(q), 8)
    wp = tier2_plain.probe(tk, tv, tu, ts, *q, 8)
    if pay:
        tpoff, tplen = want[5:7]
        gp = gp + cache_mod._probe_payload(*on([tk, tu, ts, tpoff, tplen]),
                                           *on(q), 9)
        wp = wp + tier2_plain.probe_payload(tk, tu, ts, tpoff, tplen, *q, 9)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(gp, wp)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), i
    assert bool(wp[0].any())
    assert (tier2_cuda.insert_launches, tier2_cuda.probe_launches) == (
        before[0] + 2 * kw["rounds"], before[1] + 1 + pay)


def test_tier2_on_a_cuda_chunk_never_runs_plain(dev, monkeypatch):
    """Every caller of the tier-2 ops on CUDA tensors launches the kernels
    and never reaches the plain twins: ``DeviceCache`` probe, payload
    probe, insert and rehash, and a static count and evaluation pass,
    whose counts report CUDA calls only."""
    from repro_torch.core.cache import DeviceCache
    from repro_torch.core.distributed import StaticCLFTJ
    from repro_torch.kernels.tier2 import cuda as tier2_cuda
    from repro_torch.kernels.tier2 import plain as tier2_plain

    def refuse(*args, **kw):
        raise AssertionError("a CUDA chunk reached the plain tier-2 ops")

    for name in ("probe", "insert", "probe_payload"):
        monkeypatch.setattr(tier2_plain, name, refuse)
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.integers(0, 300, 1 << 10)).to(dev)
    active = torch.from_numpy(rng.random(1 << 10) < 0.7).to(dev)
    before = (tier2_cuda.insert_launches, tier2_cuda.probe_launches)
    tbl = DeviceCache.create(PAYLOAD, 64, device=dev)
    tbl.insert(keys, keys.clamp(min=0), active)
    hit, _ = tbl.probe(keys, active)
    tbl.insert(keys, keys.clamp(min=0), active,
               poff=torch.zeros_like(keys, dtype=torch.int32),
               plen=torch.ones_like(keys, dtype=torch.int32))
    phit, _, _ = tbl.probe_payload(keys, active)
    tbl._rehash(128)
    st = tbl.stats()
    assert bool(hit.any()) and bool(phit.any()) and st["slots"] == 128
    assert st["occupancy"] > 0
    assert (tier2_cuda.insert_launches, tier2_cuda.probe_launches) == (
        before[0] + 3 * 2 * min(PAYLOAD.ways, 8), before[1] + 2)
    q = cycle_query(4)
    db = _db(nv=16, ne=120)
    td, order = engine.plan_query(q, db)
    eng = StaticCLFTJ(q, td, order, db, capacity=1 << 15, cache=PAYLOAD,
                      device=dev)
    eng.count_fn()(eng.initial_frontier())
    eng.evaluate_static()
    for op in ("probe", "insert"):
        assert eng.stats[f"tier2_{op}_calls_cuda"] > 0, op
        assert eng.stats[f"tier2_{op}_calls_torch"] == 0, op
