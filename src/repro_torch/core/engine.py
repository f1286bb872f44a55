"""Public join-engine API: plan + execute CLFTJ/LFTJ on the card, and the
paper's host engines.

    from repro_torch.core import engine
    res = engine.count(q, db)                     # plans a TD, runs CLFTJ
    res = engine.count(q, db, algorithm="lftj")   # vanilla trie join
    res = engine.count(q, db, backend="ref")      # paper-faithful host engines
    res = engine.count(q, db, algorithm="ytd", backend="ref")  # Yannakakis
    res = engine.evaluate(q, db)                  # materialized tuples
    res = engine.evaluate(q, db, cache=CacheConfig(cache_payloads=True))
    for block in engine.evaluate_stream(q, db):   # streamed row blocks
        ...
    res = engine.count(q, db, device="cpu")       # plain kernels, on the CPU
    res = engine.count(q, db, expand_kernel="chain", impl="leapfrog")
    with engine.serve(db) as srv:                 # long-lived server
        res = srv.evaluate(q)

Engines run on ``device="cuda"`` unless the caller asks for the CPU; the
default raises when CUDA is missing.  ``Result`` separates ``plan_s``
(TD/order planning), ``compile_s`` (the one-time CUDA kernel build; 0
when the library was already built) and ``exec_s`` (the remainder).
``Result.counters`` carries the tier-1/tier-2 statistics and the kernel
launches per path (``expand_calls_cuda`` / ``expand_calls_torch``, and
likewise ``fold_``, ``fold_splice_`` and ``emit_``; chain EXPANDs as
``expand_calls_chain`` and their leapfrog bound calls as
``bound_calls_cuda`` / ``bound_calls_torch``), so a run shows which path
did the work.

``expand_kernel`` picks the EXPAND path, ``"fused"`` (the EXPAND kernel,
the default) or ``"chain"`` (the op chain), and ``impl`` the chain's
bounded search, ``"bsearch"`` (the default) or ``"leapfrog"`` (the
leapfrog kernel); the fused path does not read ``impl``.
``fold_kernel`` and ``emit_kernel`` pick the FOLD and EMIT paths of an
evaluation the same way (``"fused"``, the default, or ``"chain"``); the
chains' launches count as ``fold_calls_chain`` / ``emit_calls_chain``.

``backend`` picks the engines: ``"torch"`` (the default) runs the device
engines above on ``device``; ``"ref"`` runs the paper's host engines
(``lftj_ref.LFTJ``, ``clftj_ref.CLFTJ`` with its ``CachePolicy``,
``yannakakis.YTD``; numpy on the CPU), the only backend of
``algorithm="ytd"``.  The host engines read ``policy`` (``count`` maps
``cache`` onto a ``CachePolicy`` when none is given, as the reference
does) and no device knob; their ``Result.counters`` are the paper's
memory-access proxies (``Counters.snapshot()``).  The reference's
``evaluate`` defaults to ``backend="ref"``; the port's runs on the card
unless the caller picks the host engines.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import cudalib
from .cache import CacheConfig
from .cached_frontier import CachedTrieJoin
from .clftj_ref import CLFTJ, CachePolicy
from .cq import CQ
from .db import Counters, Database
from .decompose import choose_plan
from .frontier import TrieJoin, resolve_device
from .lftj_ref import LFTJ
from .td import TreeDecomposition
from .yannakakis import YTD

__all__ = ["Result", "ResultStream", "CompileClock", "count", "evaluate",
           "evaluate_stream", "serve", "plan_query", "ALGORITHMS",
           "BACKENDS"]

ALGORITHMS = ("clftj", "lftj", "ytd")
BACKENDS = ("torch", "ref")


@dataclass
class Result:
    count: int
    tuples: Optional[np.ndarray]
    algorithm: str
    device: str
    order: Tuple[str, ...]
    td: Optional[TreeDecomposition]
    backend: str = "torch"  # "torch" (device engines) | "ref" (host)
    counters: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0     # end-to-end (= plan_s + compile_s + exec_s)
    plan_s: float = 0.0     # TD enumeration + order selection
    compile_s: float = 0.0  # one-time CUDA kernel build
    exec_s: float = 0.0     # engine execution

    @property
    def tier2_replay_hits(self) -> int:
        """Evaluation-mode tier-2 hits served by row-block replay: parent
        rows whose bag subtree was spliced from the payload slab instead
        of re-expanded; 0 unless the engine ran with
        ``cache_payloads=True``."""
        return int(self.counters.get("tier2_replay_hits", 0))

    @property
    def fold_paths(self) -> Dict[str, int]:
        """FOLD launches per path (``fold_kernel`` dispatch): ``{"cuda":
        n, "torch": n, "chain": n}``; empty for the host engines."""
        return {k[len("fold_calls_"):]: int(v)
                for k, v in self.counters.items()
                if k.startswith("fold_calls_")}

    @property
    def plan_cache_hit(self) -> bool:
        """True when the serving layer answered this query with a
        plan-cached engine (``repro_torch.serve``): planning and engine
        construction were skipped and its tier-2 tables were warm from
        earlier queries.  Always False for the one-shot facade calls."""
        return bool(self.counters.get("plan_cache_hit", 0))


class CompileClock:
    """Seconds this process spends building the CUDA kernels while the
    scope is open (``total``, set on exit; 0 when the library was already
    built).  The facade charges them to ``Result.compile_s``; the serving
    layer opens one around each session."""

    def __init__(self) -> None:
        self.total = 0.0
        self._start = 0.0

    def __enter__(self) -> "CompileClock":
        self._start = cudalib.build_seconds()
        return self

    def __exit__(self, *exc) -> bool:
        self.total = cudalib.build_seconds() - self._start
        return False


def serve(db: Database, config=None, **kwargs):
    """Open a long-lived query server over ``db``: a
    :class:`repro_torch.serve.JoinServer` with a plan cache (isomorphic
    queries share engines), tier-2 tables that persist across queries
    (and across processes through snapshots), and bounded concurrent
    streaming sessions.  ``config`` is a
    :class:`repro_torch.configs.paper_clftj.JoinEngineConfig` (default
    ``GPU_SERVE``); other keyword arguments (``device``, ``max_sessions``,
    ...) go to the server."""
    from ..serve import JoinServer  # lazy: serve imports this module
    return JoinServer(db, config=config, **kwargs)


def plan_query(q: CQ, db: Optional[Database] = None,
               max_adhesion: int = 2,
               ) -> Tuple[TreeDecomposition, Tuple[str, ...]]:
    stats = db.stats() if db is not None else None
    return choose_plan(q, stats, max_adhesion=max_adhesion)


def _plan(q: CQ, db: Database, td, order):
    if td is None or order is None:
        td_, order_ = plan_query(q, db)
        td = td if td is not None else td_
        order = order if order is not None else order_
    return td, tuple(order)


def _build_kernels(dev: torch.device) -> float:
    """Load (building if needed) the CUDA kernels; the build's seconds."""
    with CompileClock() as cc:
        if dev.type == "cuda":
            cudalib.load()
    return cc.total


def _engine(q: CQ, db: Database, algorithm: str, td, order, capacity: int,
            dedup: bool, cache: Optional[CacheConfig], dev: torch.device,
            **knobs):
    if algorithm == "clftj":
        return CachedTrieJoin(q, td, order, db, capacity=capacity,
                              dedup=dedup, cache=cache, device=dev, **knobs)
    return TrieJoin(q, order, db, capacity=capacity, device=dev, **knobs)


def _counters(eng, algorithm: str) -> Dict[str, int]:
    return (dict(eng.stats) if algorithm == "clftj"
            else eng.call_counts())


def _check_run(algorithm: str, backend: str) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                         f"got {algorithm!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if algorithm == "ytd" and backend != "ref":
        raise ValueError("algorithm='ytd' runs on the host engines only: "
                         "pass backend='ref'")


def _run_ref(q: CQ, db: Database, algorithm: str, td, order,
             policy: Optional[CachePolicy], evaluate: bool):
    """One host-engine run: ``(count, rows, counters)``, ``rows`` int64
    over ``order`` (over ``q.variables`` for YTD), as the reference's
    facade gives them."""
    counters = Counters()
    if algorithm == "clftj":
        eng = CLFTJ(q, td, order, db, policy, counters)
    elif algorithm == "lftj":
        eng = LFTJ(q, order, db, counters)
    else:
        eng = YTD(q, td, db, counters)
    if not evaluate:
        return eng.count(), None, counters.snapshot()
    width = len(q.variables) if algorithm == "ytd" else len(order)
    rows = np.asarray(list(eng.evaluate()), dtype=np.int64).reshape(
        -1, width)
    return rows.shape[0], rows, counters.snapshot()


def _run(q: CQ, db: Database, algorithm: str, td, order, capacity: int,
         dedup: bool, cache: Optional[CacheConfig], device, backend: str,
         policy: Optional[CachePolicy], evaluate: bool, **knobs) -> Result:
    _check_run(algorithm, backend)
    dev = resolve_device(device) if backend == "torch" else None
    t0 = time.perf_counter()
    td, order = _plan(q, db, td, order)
    t1 = time.perf_counter()
    if backend == "ref":
        c, rows, counters = _run_ref(q, db, algorithm, td, order, policy,
                                     evaluate)
        t2 = time.perf_counter()
        return Result(count=c, tuples=rows, algorithm=algorithm,
                      device="cpu", order=order, td=td, backend=backend,
                      counters=counters, wall_s=t2 - t0, plan_s=t1 - t0,
                      exec_s=t2 - t1)
    compile_s = _build_kernels(dev)
    eng = _engine(q, db, algorithm, td, order, capacity, dedup, cache, dev,
                  **knobs)
    rows = None
    if evaluate:
        blocks = list(eng.evaluate())
        rows = (np.concatenate(blocks, axis=0) if blocks
                else np.zeros((0, len(order)), np.int32))
        c = rows.shape[0]
    else:
        c = eng.count()
    counters = _counters(eng, algorithm)
    t2 = time.perf_counter()
    return Result(count=c, tuples=rows, algorithm=algorithm, device=str(dev),
                  order=order, td=td, backend=backend, counters=counters,
                  wall_s=t2 - t0, plan_s=t1 - t0, compile_s=compile_s,
                  exec_s=(t2 - t1) - compile_s)


def count(q: CQ, db: Database, algorithm: str = "clftj",
          td: Optional[TreeDecomposition] = None,
          order: Optional[Sequence[str]] = None, capacity: int = 1 << 16,
          dedup: bool = True, cache: Optional[CacheConfig] = None,
          device="cuda", impl: str = "bsearch",
          expand_kernel: str = "fused", fold_kernel: str = "fused",
          emit_kernel: str = "fused", backend: str = "torch",
          policy: Optional[CachePolicy] = None) -> Result:
    """Count ``q`` over ``db``.  ``cache`` configures the tier-2 cache of
    the CLFTJ engine (policy / associativity / slots / dynamic budget); on
    ``backend="ref"`` it is mapped onto the host CLFTJ's
    :class:`CachePolicy` (``CachePolicy.from_cache_config``) unless an
    explicit ``policy`` is given."""
    if backend == "ref" and policy is None and cache is not None:
        policy = CachePolicy.from_cache_config(cache)
    return _run(q, db, algorithm, td, order, capacity, dedup, cache, device,
                backend, policy, evaluate=False, impl=impl,
                expand_kernel=expand_kernel, fold_kernel=fold_kernel,
                emit_kernel=emit_kernel)


def evaluate(q: CQ, db: Database, algorithm: str = "clftj",
             td: Optional[TreeDecomposition] = None,
             order: Optional[Sequence[str]] = None, capacity: int = 1 << 16,
             dedup: bool = True, cache: Optional[CacheConfig] = None,
             device="cuda", impl: str = "bsearch",
             expand_kernel: str = "fused", fold_kernel: str = "fused",
             emit_kernel: str = "fused", backend: str = "torch",
             policy: Optional[CachePolicy] = None) -> Result:
    """Materialize ``q``'s full result: ``Result.tuples`` is an (N, n)
    int32 array over ``Result.order`` columns, in the engine's block
    order (tier-1 representatives replayed as row blocks).  With
    ``cache=CacheConfig(cache_payloads=True)`` tier 2 serves evaluation
    too: recurring subjoins splice their cached row blocks instead of
    re-expanding (``Result.tier2_replay_hits``).  On ``backend="ref"``
    the tuples are the host engine's, int64, in its order (over
    ``q.variables`` for YTD), and the host CLFTJ caches under ``policy``
    alone, as in the reference."""
    return _run(q, db, algorithm, td, order, capacity, dedup, cache, device,
                backend, policy, evaluate=True, impl=impl,
                expand_kernel=expand_kernel, fold_kernel=fold_kernel,
                emit_kernel=emit_kernel)


@dataclass
class ResultStream:
    """The streaming-evaluation surface: iterate to receive (k, n) int32
    result blocks in arrival order; once exhausted, ``result`` holds the
    :class:`Result` with the exact one-shot count and counters and
    ``tuples=None`` (the rows were already streamed).  The stream is
    consumer-driven, so ``exec_s``/``wall_s`` span the whole drain,
    including time the consumer spends between blocks."""

    order: Tuple[str, ...]
    _gen: Iterator[np.ndarray] = field(repr=False)
    result: Optional[Result] = None

    def __iter__(self) -> Iterator[np.ndarray]:
        return self._gen


def evaluate_stream(q: CQ, db: Database, algorithm: str = "clftj",
                    td: Optional[TreeDecomposition] = None,
                    order: Optional[Sequence[str]] = None,
                    capacity: int = 1 << 16, dedup: bool = True,
                    cache: Optional[CacheConfig] = None,
                    emit_in_flight: int = 8, stream_interior: bool = True,
                    device="cuda", impl: str = "bsearch",
                    expand_kernel: str = "fused", fold_kernel: str = "fused",
                    emit_kernel: str = "fused",
                    backend: str = "torch") -> ResultStream:
    """Evaluate ``q`` as a *stream*: returns a :class:`ResultStream` whose
    iterator yields materialized (k, n) int32 blocks in arrival order —
    each block's device→host copy issued asynchronously as the executor
    produces it, at most ``emit_in_flight`` copies in flight — instead of
    buffering the whole result.  Only the device trie-join engines
    stream (``algorithm`` "clftj" or "lftj" on ``backend="torch"``): the
    host engines have no device→host copy to overlap."""
    if backend != "torch" or algorithm not in ("clftj", "lftj"):
        raise ValueError(
            f"evaluate_stream supports the device clftj/lftj engines only, "
            f"got algorithm={algorithm!r} backend={backend!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    td_, order_ = _plan(q, db, td, order)
    t1 = time.perf_counter()
    stream = ResultStream(order=order_, _gen=iter(()))

    def _gen() -> Iterator[np.ndarray]:
        n_rows = 0
        compile_s = _build_kernels(dev)
        eng = _engine(q, db, algorithm, td_, order_, capacity, dedup, cache,
                      dev, emit_in_flight=emit_in_flight,
                      stream_interior=stream_interior, impl=impl,
                      expand_kernel=expand_kernel, fold_kernel=fold_kernel,
                      emit_kernel=emit_kernel)
        for block in eng.evaluate_stream():
            n_rows += block.shape[0]
            yield block
        t2 = time.perf_counter()
        stream.result = Result(
            count=n_rows, tuples=None, algorithm=algorithm,
            device=str(dev), order=order_, td=td_,
            counters=_counters(eng, algorithm), wall_s=t2 - t0,
            plan_s=t1 - t0, compile_s=compile_s,
            exec_s=(t2 - t1) - compile_s)

    stream._gen = _gen()
    return stream
