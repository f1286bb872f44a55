"""The static pass's spans and row counters (``repro_torch.core.trace``,
``schedule.execute_static``, ``StaticCLFTJ.read_counters``), on the CPU.

Tracing off, a span is one shared no-op context and the pass dispatches
the ops of a traced pass less the counters' own; tracing on, a profiled
pass holds every ``ctj.*`` span in its nesting with every aten op under
one, and each counter equals a recount of what the pass did.  Also
``scripts/static_spans.py``'s reduction of a trace by span, on synthetic
kineto events and on a profiled CPU pass of the benchmark cell."""
import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import cache as cache_mod
from repro_torch.core import engine, schedule, trace
from repro_torch.core.cache import CacheConfig
from repro_torch.core.cq import cycle_query
from repro_torch.core.db import graph_db
from repro_torch.core.distributed import StaticCLFTJ
from repro_torch.core.hostsync import SyncCounter

CAP = 1 << 13
COUNT = dict(policy="setassoc", assoc=4, slots=1 << 8)
PAY = dict(COUNT, cache_payloads=True, payload_rows=1 << 12)
# each span's enclosing span (None: outside every span)
PARENT = {"ctj.initial_frontier": None, "ctj.pass": None,
          "ctj.tables": "ctj.pass", "ctj.expand": "ctj.pass",
          "ctj.enter": "ctj.pass", "ctj.fold": "ctj.pass",
          "ctj.emit": "ctj.pass", "ctj.tier2.probe": "ctj.enter",
          "ctj.tier1.dedup": "ctj.enter", "ctj.tier2.insert": "ctj.fold"}
# the pass's own allocations before its first op (its accumulators and
# row index), the only ops directly under ``ctj.pass``
PREAMBLE = {"aten::zeros", "aten::arange", "aten::empty", "aten::zero_",
            "aten::fill_", "aten::resize_"}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.enable(False)
    yield
    trace.enable(False)


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    return graph_db(rng.integers(0, 24, size=(90, 2)), symmetrize=True)


def _engine(db, cfg=COUNT):
    q = cycle_query(4)
    td, order = engine.plan_query(q, db)
    return StaticCLFTJ(q, td, order, db, capacity=CAP,
                       cache=CacheConfig(**cfg), device="cpu")


def _one_pass(eng, mode):
    F0 = eng.initial_frontier()
    if mode == "count":
        return eng.count_fn()(F0)
    return eng.evaluate_fn()(F0, eng.make_tables("evaluate"))


class _Ops(TorchDispatchMode):
    """The ops dispatched inside, with their outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), tuple(out.shape)
                         if isinstance(out, torch.Tensor) else None))
        return out


def test_span_off_is_one_shared_null_context():
    a, b = trace.span("ctj.pass"), trace.span("ctj.expand")
    assert a is b is trace._NULL
    with a:
        pass
    trace.enable(True)
    assert trace.enabled()
    assert isinstance(trace.span("ctj.pass"),
                      torch.profiler.record_function)


@pytest.mark.parametrize("mode,cfg", [("count", COUNT), ("evaluate", PAY)])
def test_untraced_pass_is_the_traced_pass_less_its_counters(db, mode, cfg):
    eng = _engine(db, cfg)
    lists = {}
    for on in (False, True, False):
        F0 = eng.initial_frontier()
        tables = eng.make_tables(mode)
        trace.enable(on)
        with _Ops() as rec:
            if mode == "count":
                eng._pass(F0, tables, "count")
            else:
                eng._pass(F0, tables, "evaluate")
        trace.enable(False)
        lists.setdefault(on, []).append(rec.ops)
    off, on = lists[False][0], lists[True][0]
    assert lists[False][1] == off
    # the spans' own enter/exit ops return no tensor; drop them
    assert all(s is None for f, s in on if f.startswith("profiler."))
    on = [o for o in on if not o[0].startswith("profiler.")]
    extra, i = [], 0
    for o in on:
        if i < len(off) and o == off[i]:
            i += 1
        else:
            extra.append(o)
    assert i == len(off), "the untraced ops are not a subsequence"
    # what remains are the counters: 0-d reductions and sums
    assert extra and all(shape == () for _, shape in extra), extra
    assert {f.split(".")[1] for f, _ in extra} <= {"sum", "sub", "add",
                                                   "_to_copy"}


def _innermost(spans, s, e):
    best = None
    for a, b, n in spans:
        if a <= s and e <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, n)
    return best


@pytest.mark.parametrize("mode,cfg", [("count", COUNT), ("evaluate", PAY)])
def test_a_traced_pass_nests_every_span_and_op(db, mode, cfg):
    eng = _engine(db, cfg)
    trace.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _one_pass(eng, mode)
    trace.enable(False)
    evs = [(e.start_ns(), e.start_ns() + max(e.duration_ns(), 0), e.name())
           for e in prof.profiler.kineto_results.events()]
    spans = [ev for ev in evs if ev[2].startswith(trace.PREFIX)]
    assert {n for _, _, n in spans} == set(PARENT)
    # an evaluation's caller makes its tables, before the pass
    parent = dict(PARENT, **{"ctj.tables": None} if mode == "evaluate"
                  else {})
    for s, e, n in spans:
        up = _innermost([x for x in spans if x != (s, e, n)], s, e)
        assert (up and up[2]) == parent[n], n
    under_pass = set()
    n_aten = 0
    for s, e, n in evs:
        if not n.startswith("aten::"):
            continue
        n_aten += 1
        inner = _innermost(spans, s, e)
        assert inner is not None, f"{n} runs outside every span"
        if inner[2] == "ctj.pass":
            under_pass.add(n)
    assert n_aten > 100
    assert under_pass <= PREAMBLE, under_pass


class _Spy:
    """Records what the pass hands the tier-2 probe, tier-1 dedup and
    EXPAND."""

    def __init__(self, monkeypatch, eng):
        self.reset()
        probe, dedup = cache_mod._probe, schedule._dedup
        make_expand = eng._expand_fn

        def spy_probe(tk, tv, tu, ts, keys, active, tick):
            out = probe(tk, tv, tu, ts, keys, active, tick)
            self.probed.append(int(active.sum()))
            self.hits.append(int(out[0].sum()))
            return out

        def spy_dedup(keys, active):
            k = keys[active].numpy()
            self.entered.append(k.size)
            self.reps.append(np.unique(k).size)
            return dedup(keys, active)

        def spy_expand(d):
            fn = make_expand(d)

            def call(F):
                out = fn(F)
                self.needed.append(int(out[1]))
                return out
            call.path = fn.path
            return call

        monkeypatch.setattr(cache_mod, "_probe", spy_probe)
        monkeypatch.setattr(schedule, "_dedup", spy_dedup)
        monkeypatch.setattr(eng, "_expand_fn", spy_expand)

    def reset(self):
        self.probed, self.hits, self.entered, self.reps = [], [], [], []
        self.needed = []


def test_counters_of_a_cold_then_a_warm_pass(db, monkeypatch):
    eng = _engine(db)
    spy = _Spy(monkeypatch, eng)
    trace.enable(True)
    total, ov, tables = eng._pass(eng.initial_frontier(),
                                  eng.make_tables("count"), "count")
    trace.enable(False)
    assert not bool(ov)
    with SyncCounter() as sc:
        cold = eng.read_counters()
    assert sc.label_counts == {"static-stats": 1}
    assert cold["tier2_hits"] == 0 == sum(spy.hits)
    assert cold["tier2_probes"] == sum(spy.probed) > 0
    assert cold["tier1_rows_entered"] == sum(spy.entered)
    assert cold["tier1_rows_collapsed"] == (
        sum(spy.entered) - sum(spy.reps)) > 0
    assert cold["expand_rows"] == sum(spy.needed) > 0
    assert 0 < cold["tier2_inserts"] <= sum(spy.reps)
    # a second pass given the first one's tables hits, with the same count
    spy.reset()
    trace.enable(True)
    total2, _, _ = eng._pass(eng.initial_frontier(), tables, "count")
    trace.enable(False)
    warm = eng.read_counters()
    assert int(total2) == int(total)
    assert warm["tier2_hits"] == sum(spy.hits) > 0
    assert warm["tier2_probes"] == sum(spy.probed)
    assert warm["tier1_rows_entered"] == sum(spy.entered)
    assert warm["tier1_rows_collapsed"] == sum(spy.entered) - sum(spy.reps)
    assert eng.stats["tier2_hits"] == warm["tier2_hits"]
    assert eng.stats["tier2_probes"] == cold["tier2_probes"] + warm[
        "tier2_probes"]


def test_untraced_passes_count_nothing(db):
    eng = _engine(db)
    fn = eng.count_fn()
    fn(eng.initial_frontier())
    with SyncCounter() as sc:
        got = eng.read_counters()
    assert sc.count == 0 and set(got.values()) == {0}
    assert eng.stats["tier2_probes"] == 0
    # counters add up over traced passes until read
    trace.enable(True)
    fn(eng.initial_frontier())
    fn(eng.initial_frontier())
    trace.enable(False)
    two = eng.read_counters()
    trace.enable(True)
    fn(eng.initial_frontier())
    trace.enable(False)
    one = eng.read_counters()
    assert two == {k: 2 * v for k, v in one.items()} and one["tier2_probes"]


# -- scripts/static_spans.py ------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location(
        "static_spans", ROOT / "scripts" / "static_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ev:
    """One kineto event, as ``static_spans.reduce`` reads it."""

    def __init__(self, name, s, e, dev=False, tid=1, corr=0):
        self._n, self._s, self._d = name, s, e - s
        self._dev, self._tid, self._c = dev, tid, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._c


def _events():
    spans = [_Ev("ctj.initial_frontier", 20, 90), _Ev("ctj.pass", 100, 1000),
             _Ev("ctj.expand", 150, 400), _Ev("ctj.fold", 500, 900),
             _Ev("ctj.tier2.insert", 600, 800)]
    host = [_Ev("aten::fill_", 30, 80), _Ev("aten::index", 160, 390),
            _Ev("cudaMemcpyAsync", 85, 88, corr=13),
            _Ev("cudaLaunchKernel", 200, 205, corr=11),
            _Ev("cudaLaunchKernel", 550, 555, corr=14),
            _Ev("cudaLaunchKernel", 650, 655, corr=12),
            # a launch outside every span
            _Ev("cudaMemcpyAsync", 1001, 1002, corr=15)]
    device = [_Ev("Memcpy HtoD", 86, 95, True, 7, 13),
              _Ev("gather", 210, 300, True, 7, 11),
              _Ev("reduce", 560, 580, True, 7, 14),
              _Ev("scatter", 660, 700, True, 7, 12),
              _Ev("Memcpy DtoH", 1003, 1004, True, 7, 15)]
    # kineto's second record of two spans on the device timeline
    annotations = [_Ev("ctj.pass", 100, 1000, True, 8),
                   _Ev("ctj.expand", 205, 305, True, 8)]
    return spans + host + device + annotations


def test_spans_script_splits_a_trace_by_innermost_span():
    got = _script().reduce(_events(), 10, 1010)
    assert got["window_s"] == pytest.approx(1000e-9)
    assert got["busy_s"] == pytest.approx(160e-9)   # no annotation
    assert got["span_device_s"] == pytest.approx({
        "ctj.initial_frontier": 9e-9, "ctj.expand": 90e-9,
        "ctj.fold": 20e-9, "ctj.tier2.insert": 40e-9})
    assert got["attributed_s"] == pytest.approx(159e-9)
    assert got["span_ops_s"]["(no span)"] == [("Memcpy DtoH", 1e-9)]
    assert got["span_host_s"] == pytest.approx({
        "ctj.initial_frontier": 70e-9, "ctj.pass": 900e-9,
        "ctj.expand": 250e-9, "ctj.fold": 400e-9,
        "ctj.tier2.insert": 200e-9})
    idle = got["idle_span_s"]
    assert sum(idle.values()) == pytest.approx(1000e-9 - 160e-9)
    # gaps [10, 86) [95, 210) [300, 560) [580, 660) [700, 1003) [1004,
    # 1010): 66 ns of the first in the frontier span, 10 before it
    assert idle["ctj.initial_frontier"] == pytest.approx(66e-9)
    assert idle["(no span)"] == pytest.approx((10 + 5 + 3 + 6) * 1e-9)
    assert idle["ctj.tier2.insert"] == pytest.approx(160e-9)
    assert idle["ctj.pass"] == pytest.approx((50 + 100 + 100) * 1e-9)


def test_spans_script_profiles_the_cell_on_the_cpu():
    mod = _script()
    from harness import spec
    cell = copy.deepcopy(spec.load_cell("graph500.static-cycle4-count"))
    cell.config["graph"].update(scale=6, edgefactor=4)
    cell.config["engine"]["cache_slots"] = 1 << 6
    cell.config["static"]["frontier_capacity"] = 1 << 17
    got = mod.profile_passes(cell, 2 ** 31 + 7, 2, "cpu")
    assert got["errors"] == [None, None]
    assert got["counts"][0] == got["counts"][1] > 0
    assert set(got["span_host_s"]) == set(PARENT)
    assert got["span_device_s"] == got["idle_span_s"] == {}
    c = got["counters"]
    assert c["tier2_hits"] == 0 < c["tier2_probes"] == c[
        "tier1_rows_entered"]
    assert 0 < c["tier1_rows_collapsed"] < c["tier1_rows_entered"]
    calls = got["calls"]
    assert calls["tier2_probe_calls_torch"] == calls[
        "tier2_insert_calls_torch"] == 2
    assert calls["tier2_probe_calls_cuda"] == calls["expand_calls_cuda"] == 0
