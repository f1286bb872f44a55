"""The tier-2 table ops' dispatch (``core/cache.py`` over
``kernels/tier2``), on the CPU.

A CPU chunk runs the plain op chains and never loads the kernel library;
the CUDA wrappers refuse CPU tensors before they load it; the static
pass counts its probes and inserts by path; the kernels' C entry points
are declared to ``cudalib`` with as many arguments as ``csrc/tier2.cu``
gives them.  The kernels themselves are held to the plain twins on the
card (``tests/test_torch_cuda.py``)."""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import cache, engine
from repro_torch.core.cache import CacheConfig
from repro_torch.core.cq import bowtie_query, cycle_query, path_query
from repro_torch.core.db import graph_db
from repro_torch.core.distributed import StaticCLFTJ
from repro_torch.core.schedule import ENTER_CHILD, FOLD_CHILD
from repro_torch.kernels import cudalib
from repro_torch.kernels.tier2 import cuda as tier2_cuda
from repro_torch.kernels.tier2 import plain as tier2_plain

POLICIES = ("direct", "setassoc", "costaware")


@pytest.fixture
def no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(cudalib, "load", refuse)


def _inputs(policy, pay, seed=0, S=8, C=200):
    rng = np.random.default_rng(seed)
    W = 1 if policy == "direct" else 4
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    table = (t(rng.integers(-30, 30, (S, W))),
             t(rng.integers(0, 50, (S, W))), t(rng.random((S, W)) < 0.5),
             t(rng.integers(0, 4, (S, W)).astype(np.int32)),
             t(rng.integers(0, 9, (S, W))))
    rows = (t(rng.integers(-30, 30, C)), t(rng.integers(0, 50, C)),
            t(rng.integers(0, 12, C)), t(rng.random(C) < 0.6))
    pays = None
    if pay:
        pays = (t(rng.integers(0, 9, (S, W)).astype(np.int32)),
                t(rng.integers(-1, 3, (S, W)).astype(np.int32)),
                t(rng.integers(0, 9, C).astype(np.int32)),
                t(rng.integers(-1, 3, C).astype(np.int32)))
    return table, rows, pays


@pytest.mark.parametrize("pay", [False, True], ids=["count", "payload"])
@pytest.mark.parametrize("policy", POLICIES)
def test_cpu_chunks_run_plain_and_never_load_the_library(no_library, policy,
                                                         pay):
    """``_insert``, ``_probe`` and ``_probe_payload`` on CPU tensors give
    the plain twins' results, and the kernel library is never loaded."""
    table, (keys, vals, costs, active), pays = _inputs(policy, pay)
    kw = dict(policy=policy, rounds=table[0].shape[1], pay=pays)
    got = cache._insert(*table, keys, vals, costs, active, 5, **kw)
    want = tier2_plain.insert(*table, keys, vals, costs, active, 5, **kw)
    assert len(got) == len(want) == (9 if pay else 7)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[-2]) > 0
    tk, tv, tu, ts = got[:4]
    for a, b in zip(cache._probe(tk, tv, tu, ts, keys, active, 6),
                    tier2_plain.probe(tk, tv, tu, ts, keys, active, 6)):
        assert torch.equal(a, b)
    if pay:
        tpoff, tplen = got[5:7]
        for a, b in zip(
                cache._probe_payload(tk, tu, ts, tpoff, tplen, keys, active,
                                     6),
                tier2_plain.probe_payload(tk, tu, ts, tpoff, tplen, keys,
                                          active, 6)):
            assert torch.equal(a, b)


def test_cuda_wrappers_refuse_cpu_tensors_before_loading(no_library):
    table, (keys, vals, costs, active), pays = _inputs("setassoc", True)
    before = (tier2_cuda.probe_launches, tier2_cuda.insert_launches)
    with pytest.raises(ValueError, match="kernel runs on"):
        tier2_cuda.probe(*table[:4], keys, active, 1)
    with pytest.raises(ValueError, match="kernel runs on"):
        tier2_cuda.probe_payload(table[0], table[2], table[3], *pays[:2],
                                 keys, active, 1)
    with pytest.raises(ValueError, match="kernel runs on"):
        tier2_cuda.insert(*table, keys, vals, costs, active, 1,
                          policy="setassoc", rounds=4, pay=pays)
    with pytest.raises(ValueError, match="unknown cache policy"):
        tier2_cuda.insert(*table, keys, vals, costs, active, 1, policy="lru")
    assert (tier2_cuda.probe_launches, tier2_cuda.insert_launches) == before


def test_tier2_entry_points_are_declared():
    """Both entry points of ``csrc/tier2.cu`` are built and declared, each
    with as many ctypes arguments as its C definition has parameters."""
    assert "tier2.cu" in cudalib.SOURCES
    src = (cudalib.CSRC / "tier2.cu").read_text()
    for name in ("ctj_tier2_probe", "ctj_tier2_insert"):
        assert name in cudalib._SIGNATURES, name
        params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                           src).group(1)
        assert len(params.split(",")) == len(cudalib._SIGNATURES[name]), name


QUERIES = {"cycle4": cycle_query(4), "bowtie": bowtie_query(),
           "path5": path_query(5)}
COUNT = dict(policy="setassoc", assoc=4, slots=1 << 8)
PAY = dict(COUNT, cache_payloads=True, payload_rows=1 << 12)


@pytest.mark.parametrize("mode", ["count", "evaluate"])
@pytest.mark.parametrize("qname", list(QUERIES))
def test_static_pass_counts_tier2_calls_by_path(no_library, qname, mode):
    """A CPU static pass counts one ``tier2_probe_calls_torch`` a probed
    ENTER and one ``tier2_insert_calls_torch`` a probed FOLD, and no CUDA
    call."""
    rng = np.random.default_rng(1)
    db = graph_db(rng.integers(0, 20, size=(80, 2)), symmetrize=True)
    q = QUERIES[qname]
    td, order = engine.plan_query(q, db)
    eng = StaticCLFTJ(q, td, order, db, capacity=1 << 13,
                      cache=CacheConfig(**(COUNT if mode == "count" else PAY)),
                      device="cpu")
    tables = eng.make_tables(mode)
    probed = [op for op in eng.schedule.ops
              if op.probe and op.node in tables]
    enters = sum(op.kind == ENTER_CHILD for op in probed)
    folds = sum(op.kind == FOLD_CHILD for op in probed)
    assert enters == folds > 0
    F0 = eng.initial_frontier()
    if mode == "count":
        eng.count_fn()(F0)
    else:
        eng.evaluate_fn()(F0, tables)
    st = eng.stats
    assert st["tier2_probe_calls_torch"] == enters
    assert st["tier2_insert_calls_torch"] == folds
    assert st["tier2_probe_calls_cuda"] == st["tier2_insert_calls_cuda"] == 0
