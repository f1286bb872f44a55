"""The static cached trie join, on one device or split over ranks.

:class:`StaticCLFTJ` runs the lowered op schedule as one fixed-capacity
pass (``schedule.execute_static``): no morsel splitting, overflow flagged
instead, tier-2 tables threaded through the pass as tuples, and one host
fetch at the end of an evaluation.

:func:`make_distributed_count` and :func:`make_distributed_evaluate` run
that pass on every rank of a ``torch.distributed`` process group: rank r
of D takes the r-th contiguous slice of the top-level variable's guard
runs (the natural LFTJ work partition), keeps private tier-2 tables
(caching is an optimisation, so no coherence traffic), and the ranks sum
their count, overflow and replay-hit figures with one ``all_reduce``.  An
evaluation also gathers every rank's result rows to every rank, in rank
order.  The group may use any backend: gloo runs on the CPU and lets
several ranks share one card; NCCL wants one card per rank.

Reference: ``repro/core/distributed.py`` (where ``shard_map`` over a
device mesh plays the process group's part).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .cache import CacheConfig
from .cached_frontier import CachedTrieJoin
from .cq import CQ
from .db import Database
from .frontier import Frontier
from . import trace
from .hostsync import device_get
from .schedule import FOLD_CHILD, ROW_COUNTERS, execute_static
from .td import TreeDecomposition

__all__ = ["StaticCLFTJ", "shard_frontier", "make_distributed_count",
           "make_distributed_evaluate"]


class StaticCLFTJ(CachedTrieJoin):
    """Fixed-capacity CLFTJ: the whole schedule as one pass per call.

    Tier-2 tables are ``(S, W)`` tensors per the :class:`CacheConfig`,
    created by :meth:`make_tables` and passed through each pass; the LRU
    tick is counted op by op.  ``stats`` adds up, over this engine's
    passes, the kernel launches per path (``fold_merged_calls_*`` for the
    merged FOLD, which ``fold_calls_*`` also counts; the op chains'
    under ``*_calls_chain``) and ``fold_sorted_exits``, the fused folds
    whose exit chunk was sorted before its kernel ran (the chain FOLD,
    ``fold_kernel="chain"``, takes unsorted exits as they come); ``last_needed_max`` holds the last pass's largest row
    need (a 0-d device tensor).

    The row counters (``schedule.ROW_COUNTERS``: ``tier2_probes``,
    ``tier2_hits``, ``tier2_inserts``, ``tier1_rows_entered``,
    ``tier1_rows_collapsed``, ``expand_rows``) are filled only by passes
    run with tracing on (``trace.enable(True)``): they add up on the
    device, and :meth:`read_counters` moves them into ``stats``.  Passes
    run with tracing off leave them as they are."""

    last_needed_max: Optional[torch.Tensor] = None
    _row_counts: Optional[Dict[str, torch.Tensor]] = None

    def make_tables(self, mode: str = "count") -> Dict[int, tuple]:
        """Fresh tier-2 tables for every probed TD node: the count-only
        ``(keys, vals, used, stamp, cost)`` 5-tuple, or, with
        ``mode="evaluate"`` and ``cache_payloads``, the 9-tuple adding
        ``(pay_off, pay_len, slab, bump)``: the payload planes, a slab
        arena of ``payload_rows + 1`` rows of the node's subtree width (the
        last row is scratch) and the arena's bump pointer."""
        with trace.span("ctj.tables"):
            cfg = self.cache_config
            if cfg.initial_slots() <= 0:
                return {}
            w = cfg.ways
            s = max(1, cfg.initial_slots() // w)
            dev = self.device
            tables: Dict[int, tuple] = {}
            for op in self.schedule.ops:
                if op.kind != FOLD_CHILD or not op.probe or op.node in tables:
                    continue
                base = (torch.zeros((s, w), dtype=torch.int64, device=dev),
                        torch.zeros((s, w), dtype=torch.int64, device=dev),
                        torch.zeros((s, w), dtype=torch.bool, device=dev),
                        torch.zeros((s, w), dtype=torch.int32, device=dev),
                        torch.zeros((s, w), dtype=torch.int64, device=dev))
                if mode == "evaluate" and cfg.cache_payloads:
                    width = op.sub_last - op.sub_first + 1
                    tables[op.node] = base + (
                        torch.zeros((s, w), dtype=torch.int32, device=dev),
                        torch.full((s, w), -1, dtype=torch.int32, device=dev),
                        torch.zeros((int(cfg.payload_rows) + 1, width),
                                    dtype=torch.int32, device=dev),
                        torch.zeros((), dtype=torch.int32, device=dev))
                else:
                    tables[op.node] = base
            return tables

    def _pass(self, F0: Frontier, tables: Dict[int, tuple], mode: str):
        counts: Dict[str, object] = {}
        out = execute_static(self.schedule, self, F0, tables,
                             self.cache_config, mode=mode, counts=counts)
        self.last_needed_max = counts.pop("needed_max")
        rows = {k: counts.pop(k) for k in ROW_COUNTERS if k in counts}
        if rows:
            acc = self._row_counts or {}
            self._row_counts = {k: acc[k] + n if k in acc else n
                                for k, n in rows.items()}
        for key, n in counts.items():
            self.stats[key] = self.stats.get(key, 0) + n
        return out

    def read_counters(self) -> Dict[str, int]:
        """The row counters of the traced passes since the last call: one
        host fetch (label ``static-stats``), none when no traced pass ran.
        Adds them into ``stats`` and zeroes them on the device."""
        acc, self._row_counts = self._row_counts, None
        if not acc:
            return dict.fromkeys(ROW_COUNTERS, 0)
        got = device_get(acc, "static-stats")
        out = {k: int(got.get(k, 0)) for k in ROW_COUNTERS}
        for key, n in out.items():
            self.stats[key] = self.stats.get(key, 0) + n
        return out

    def count_fn(self):
        """A function ``fn(F0) -> (count, overflow)``: one count pass from
        the chunk ``F0`` with fresh count tables, both results 0-d device
        tensors."""
        def fn(F0: Frontier):
            with trace.span("ctj.pass"):
                total, ov, _ = self._pass(F0, self.make_tables("count"),
                                          "count")
            return total, ov

        return fn

    def evaluate_fn(self):
        """A function ``fn(F0, tables) -> (assign, valid, count, overflow,
        replay_hits, tables)``: one evaluation pass, every result on the
        device (the valid rows packed to the front of ``assign``), the
        tables to pass back in for a warm pass.  The slabs in ``tables``
        are written in place."""
        def fn(F0: Frontier, tables: Dict[int, tuple]):
            with trace.span("ctj.pass"):
                return self._pass(F0, tables, "evaluate")

        return fn

    def evaluate_static(self, tables: Optional[Dict[int, tuple]] = None):
        """One evaluation pass on this engine's device and one host fetch
        (label ``static-eval``).  Returns ``(rows, stats, tables)``: the
        ``(N, n)`` int32 result rows, ``stats`` with ``count``,
        ``overflow`` and ``tier2_replay_hits``, and the updated tables,
        which a second call takes for a warm pass (recurring adhesion
        keys then splice their stored blocks instead of re-expanding)."""
        if tables is None:
            tables = self.make_tables("evaluate")
        assign, valid, total, ov, hits, tables = self.evaluate_fn()(
            self.initial_frontier(), tables)
        a, v, t, o, h = device_get((assign, valid, total, ov, hits),
                                   "static-eval")
        stats = {"count": int(t), "overflow": bool(o),
                 "tier2_replay_hits": int(h)}
        return a[v], stats, tables


def shard_frontier(eng: CachedTrieJoin, index: int, count: int
                   ) -> Frontier:
    """The initial chunk of shard ``index`` of ``count``: the engine's
    initial chunk with the top-level guard atom's window cut to its guard
    runs ``[index·R/count, (index+1)·R/count)`` of the R runs.  Count and
    evaluation both shard through this one function, so they split the
    same rows."""
    g_ai, g_lvl = eng.at_depth[0][eng.guard[0]]
    rs = eng.levels[g_ai][g_lvl].runstarts_np
    nruns, n_rows = rs.shape[0], eng.sizes[g_ai]
    r0 = (index * nruns) // count
    r1 = ((index + 1) * nruns) // count
    F0 = eng.initial_frontier()
    F0.lo[0, g_ai] = int(rs[r0]) if r0 < nruns else n_rows
    F0.hi[0, g_ai] = int(rs[r1]) if r1 < nruns else n_rows
    return F0


def _rank_and_size(group) -> Tuple[int, int]:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the distributed join needs an initialised torch.distributed "
            "process group (init_process_group)")
    return dist.get_rank(group), dist.get_world_size(group)


def make_distributed_count(q: CQ, td: TreeDecomposition,
                           order: Sequence[str], db: Database,
                           capacity: int = 1 << 14,
                           cache: Optional[CacheConfig] = None,
                           device="cuda", group=None,
                           expand_kernel: str = "fused",
                           impl: str = "bsearch",
                           fold_kernel: str = "fused",
                           emit_kernel: str = "fused"):
    """Build ``(fn, engine)`` for a count over the process group: ``fn()``
    runs this rank's shard and returns ``(count, overflow)``, the sums
    over all ranks as 0-d int64 tensors on the engine's device
    (``overflow`` is the number of ranks whose pass overflowed).  Every
    rank must call ``fn`` together.  Raises without an initialised
    process group.  The default cache is direct-mapped with 2^15 slots.
    ``expand_kernel``, ``impl``, ``fold_kernel`` and ``emit_kernel`` pick
    every rank's kernel paths, as on :class:`StaticCLFTJ`."""
    rank, size = _rank_and_size(group)
    if cache is None:
        cache = CacheConfig(policy="direct", slots=1 << 15)
    eng = StaticCLFTJ(q, td, order, db, capacity=capacity, cache=cache,
                      device=device, expand_kernel=expand_kernel, impl=impl,
                      fold_kernel=fold_kernel, emit_kernel=emit_kernel)
    count_fn = eng.count_fn()

    def fn():
        total, ov = count_fn(shard_frontier(eng, rank, size))
        sums = torch.stack([total.to(torch.int64), ov.to(torch.int64)])
        dist.all_reduce(sums, group=group)
        return sums[0], sums[1]

    return fn, eng


def make_distributed_evaluate(q: CQ, td: TreeDecomposition,
                              order: Sequence[str], db: Database,
                              capacity: int = 1 << 14,
                              cache: Optional[CacheConfig] = None,
                              device="cuda", group=None,
                              expand_kernel: str = "fused",
                              impl: str = "bsearch",
                              fold_kernel: str = "fused",
                              emit_kernel: str = "fused"):
    """Build ``(run, engine)`` for a payload-capable evaluation over the
    process group.

    ``run(tables=None)`` evaluates this rank's shard with this rank's own
    tier-2 tables (fresh ones when ``None``), sums count, overflow and
    replay hits over the ranks, gathers every rank's result rows in rank
    order, and returns ``(rows, stats, tables)``: the merged rows (the
    same on every rank), ``stats`` with ``count``, ``overflow`` (a bool),
    ``overflow_shards`` and ``tier2_replay_hits``, and this rank's tables,
    which the next call takes for a warm pass.  Every rank must call
    ``run`` together.  Raises without an initialised process group.  The
    default cache is direct-mapped with 2^15 slots and payloads on (an
    explicit payloads-off config evaluates exactly but never replays).
    ``expand_kernel``, ``impl``, ``fold_kernel`` and ``emit_kernel`` pick
    every rank's kernel paths, as on :class:`StaticCLFTJ`."""
    rank, size = _rank_and_size(group)
    if cache is None:
        cache = CacheConfig(policy="direct", slots=1 << 15,
                            cache_payloads=True)
    eng = StaticCLFTJ(q, td, order, db, capacity=capacity, cache=cache,
                      device=device, expand_kernel=expand_kernel, impl=impl,
                      fold_kernel=fold_kernel, emit_kernel=emit_kernel)
    eval_fn = eng.evaluate_fn()

    def run(tables: Optional[Dict[int, tuple]] = None):
        if tables is None:
            tables = eng.make_tables("evaluate")
        assign, valid, total, ov, hits, tables = eval_fn(
            shard_frontier(eng, rank, size), tables)
        sums = torch.stack([total.to(torch.int64), ov.to(torch.int64),
                            hits.to(torch.int64)])
        dist.all_reduce(sums, group=group)
        a, v, s = device_get((assign, valid, sums), "dist-eval-rows")
        parts = [None] * size
        dist.all_gather_object(parts, a[v], group=group)
        rows = (np.concatenate(parts, axis=0) if parts else
                np.zeros((0, eng.n), np.int32))
        stats = {"count": int(s[0]), "overflow": bool(s[1]),
                 "overflow_shards": int(s[1]),
                 "tier2_replay_hits": int(s[2])}
        return rows, stats, tables

    return run, eng
