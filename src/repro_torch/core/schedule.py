"""Execution IR for the vectorized trie join: one schedule, one executor.

This module lowers ``(CQ, TreeDecomposition, order)`` into a *linear
instruction schedule* over four ops:

  * ``EXPAND(d)``        — frontier expansion of order variable ``x_d``
  * ``ENTER_CHILD(c)``   — TD-node entry: tier-2 probe + tier-1 dedup,
                           parent chunk parked on an explicit frame stack
  * ``FOLD_CHILD(c)``    — TD-node exit: segment counts, tier-2 insert,
                           factor multiplication (count mode) or replay of
                           representative row blocks through ``orig``
                           (evaluate mode — the paper §3.4's factorized
                           intermediates, materialized; with
                           ``cache_payloads`` the blocks are also stored
                           in / spliced from the tier-2 slab arena)
  * ``EMIT``             — accumulate counts / pack result tuples

The TD recursion is flattened at lowering time: a subtree's ops are *data*
(a bracketed ``ENTER … FOLD`` span in the op list), not Python call frames.
:class:`ScheduleExecutor` is the host-driven engine: morsel splitting, the
tier-2 cache (``core/cache.py``), batched chunk admission so host syncs
happen at most once per op execution (not per chunk — every sync is routed
through :mod:`hostsync`), while parent morsels still run an ENTER…FOLD
span sequentially so later morsels hit earlier morsels' tier-2 inserts.
:func:`execute_static` is the fixed-capacity executor: the whole schedule
as one pass over one chunk per op, overflow flagged instead of split,
tier-2 tables threaded through as tuples, and no host sync inside.
EXPAND, the evaluation-mode FOLD (replay, splice and their merged arity)
and the EMIT pack are kernels behind ``kernels/registry.py``, each on the
path its engine knob names (``expand_kernel`` / ``fold_kernel`` /
``emit_kernel``: ``"fused"``, the kernel, or ``"chain"``, the op chain);
the slab store (:func:`_store_blocks`) is plain PyTorch ops.

Reference: ``repro/core/schedule.py``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.registry import path_of
from . import trace
from .hostsync import AsyncFetchQueue, device_get, device_get_async

MAX_KEY_BITS = 21  # packed adhesion keys: values must fit in 21 bits

# kernel launch counters of a pass, per path: "cuda" | "torch"
# (registry.path_of) for the fused path, "chain" for the op chain on any
# device (launch_path).  "fold" counts both FOLD arities, "fold_splice"
# the splice alone; a chain EXPAND's leapfrog bound calls land in
# "bound_calls_*"
# the static pass's row counters, kept only while tracing is on
ROW_COUNTERS = ("tier2_probes", "tier2_hits", "tier2_inserts",
                "tier1_rows_entered", "tier1_rows_collapsed", "expand_rows")
CALL_COUNTERS = tuple(
    f"{op}_calls_{path}" for op in ("expand", "fold", "fold_splice", "emit")
    for path in ("cuda", "torch", "chain")) + (
    "bound_calls_cuda", "bound_calls_torch")


def launch_path(fn, t: torch.Tensor) -> str:
    """The path one call of the registry-built step ``fn`` on a chunk on
    ``t``'s device takes: ``"chain"`` for the op chain, else the fused
    path's ``"cuda"`` | ``"torch"``."""
    return "chain" if fn.path == "chain" else path_of(t)


def expand_launches(fn, t: torch.Tensor) -> Dict[str, int]:
    """What one call of the registry-built EXPAND step ``fn`` on a chunk
    on ``t``'s device adds to the launch counters: one fused EXPAND on
    its path, or one chain EXPAND and its leapfrog bound calls."""
    out = {f"expand_calls_{launch_path(fn, t)}": 1}
    if fn.path == "chain":
        out[f"bound_calls_{path_of(t)}"] = fn.bound_calls
    return out

# ---------------------------------------------------------------------------
# The IR
# ---------------------------------------------------------------------------

EXPAND = "expand"
ENTER_CHILD = "enter_child"
FOLD_CHILD = "fold_child"
EMIT = "emit"


@dataclass(frozen=True)
class Op:
    """One schedule instruction (see module docstring for semantics).

    ``probe``/``dedup`` are *eligibility* flags resolved at lowering time
    (key packs into int64, adhesion dim <= 2, node enabled, engine dedup
    setting); the executor still ANDs ``probe`` with its runtime cache
    state (manager enabled, count-vs-evaluate mode).
    """

    kind: str
    d: int = -1                      # EXPAND: depth (order position)
    node: int = -1                   # ENTER/FOLD: TD node id
    adhesion: Tuple[int, ...] = ()   # ENTER/FOLD: order positions of α
    probe: bool = False              # ENTER: tier-2 eligible (FOLD: insert)
    dedup: bool = False              # ENTER: tier-1 eligible
    sub_first: int = -1              # FOLD: first depth owned inside t|c
    sub_last: int = -1               # FOLD: last depth owned inside t|c

    def __str__(self) -> str:
        if self.kind == EXPAND:
            return f"EXPAND(d={self.d})"
        if self.kind == ENTER_CHILD:
            return (f"ENTER_CHILD(c={self.node}, α={self.adhesion}, "
                    f"probe={self.probe}, dedup={self.dedup})")
        if self.kind == FOLD_CHILD:
            return (f"FOLD_CHILD(c={self.node}, "
                    f"sub=[{self.sub_first},{self.sub_last}])")
        return "EMIT"


@dataclass(frozen=True)
class Schedule:
    """A lowered, validated linear op list for one (query, TD, order)."""

    ops: Tuple[Op, ...]
    n: int  # number of order variables

    def __post_init__(self):
        depths = [op.d for op in self.ops if op.kind == EXPAND]
        if depths != list(range(self.n)):
            raise ValueError(f"EXPAND depths {depths} != 0..{self.n - 1}")
        if not self.ops or self.ops[-1].kind != EMIT:
            raise ValueError("schedule must end with EMIT")
        stack: List[int] = []
        for op in self.ops:
            if op.kind == ENTER_CHILD:
                stack.append(op.node)
            elif op.kind == FOLD_CHILD:
                if not stack or stack[-1] != op.node:
                    raise ValueError(
                        f"FOLD_CHILD({op.node}) does not match open "
                        f"ENTER stack {stack}")
                stack.pop()
        if stack:
            raise ValueError(f"unclosed ENTER_CHILD nodes {stack}")

    def describe(self) -> str:
        return "\n".join(str(op) for op in self.ops)

    def signature(self) -> str:
        """Stable structural hash of the lowered op list (kind, depth,
        node, adhesion and the eligibility flags of every op), as the
        reference computes it.  Engines with equal signatures execute the
        same instruction stream, so tier-2 state persisted under it
        (``serve/persist.py``) replays safely; a lowering change
        invalidates old snapshots by changing the signature."""
        parts = [(op.kind, op.d, op.node, op.adhesion, op.probe, op.dedup,
                  op.sub_first, op.sub_last) for op in self.ops]
        blob = repr((self.n, parts)).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def lower(n: int, plan: Optional[Any] = None,
          cacheable: Optional[Callable[[int], bool]] = None,
          dedup: bool = True) -> Schedule:
    """Compile ``(order length, Plan)`` into a linear schedule.

    ``plan`` is a :class:`~.clftj_ref.Plan` (TD/order correspondence);
    ``plan=None`` lowers the vanilla LFTJ (no TD): EXPAND over every depth
    then EMIT.  ``cacheable(c)`` resolves per-node key eligibility
    (packability, adhesion dimension, enabled_nodes); ``dedup`` is the
    engine's tier-1 switch — both are baked into op flags.
    """
    ops: List[Op] = []
    if plan is None:
        ops.extend(Op(EXPAND, d=d) for d in range(n))
    else:
        can = cacheable if cacheable is not None else (lambda c: False)

        def emit_node(v: int) -> None:
            if v in plan.first_d:
                ops.extend(Op(EXPAND, d=d) for d in
                           range(plan.first_d[v], plan.last_d[v] + 1))
            for c in plan.td.children[v]:
                keyable = bool(can(c))
                adh = tuple(plan.adhesion_idx[c])
                ops.append(Op(ENTER_CHILD, node=c, adhesion=adh,
                              probe=keyable, dedup=keyable and dedup))
                emit_node(c)
                ops.append(Op(FOLD_CHILD, node=c, adhesion=adh,
                              probe=keyable, dedup=keyable and dedup,
                              sub_first=plan.first_d[c],
                              sub_last=plan.subtree_last[c]))

        emit_node(plan.td.root)
    ops.append(Op(EMIT))
    return Schedule(tuple(ops), n)


# ---------------------------------------------------------------------------
# Chunk ops (chunk type is any Frontier-shaped NamedTuple —
# assign/factor/valid/orig/lo/hi)
# ---------------------------------------------------------------------------


def _pack_keys(assign: torch.Tensor, idx: Tuple[int, ...],
               node: int) -> torch.Tensor:
    """Pack <=2 adhesion columns + node id into one int64 key."""
    key = torch.full((assign.shape[0],), node, dtype=torch.int64,
                     device=assign.device)
    for i in idx:
        key = (key << MAX_KEY_BITS) | assign[:, i].to(torch.int64)
    return key


def _dedup(keys: torch.Tensor, active: torch.Tensor):
    """Unique active keys: returns (first_idx, rep_of_row, n_reps).

    * ``first_idx[r]``   — row index of representative r (garbage for r >=
      n_reps),
    * ``rep_of_row[i]``  — representative id of row i (garbage if inactive),
    * ``n_reps``         — number of distinct active keys (0-d int32).
    """
    C = keys.shape[0]
    i32 = torch.int32
    big = 2 ** 62
    k = torch.where(active, keys, big)  # inactive rows sort to the back
    order = torch.argsort(k, stable=True)
    ks = k[order]
    isfirst = torch.ones(C, dtype=torch.bool, device=keys.device)
    isfirst[1:] = ks[1:] != ks[:-1]
    isfirst &= ks != big
    rep_sorted = torch.cumsum(isfirst, 0, dtype=i32) - 1
    n_reps = isfirst.sum(dtype=i32)
    rep_of_row = torch.zeros(C, dtype=i32, device=keys.device)
    rep_of_row[order] = rep_sorted  # order is a permutation: unique writes
    # first occurrence row index per rep (scatter-max; -1 writes are no-ops)
    first_idx = torch.zeros(C, dtype=i32, device=keys.device).scatter_reduce_(
        0, rep_sorted.clamp(0, C - 1).long(),
        torch.where(isfirst, order.to(i32), -1), "amax")
    return first_idx, rep_of_row, n_reps


def _make_rep_frontier(F, first_idx: torch.Tensor, n_reps: torch.Tensor):
    C = F.assign.shape[0]
    ar = torch.arange(C, dtype=torch.int32, device=F.assign.device)
    rep_valid = ar < n_reps
    src = first_idx.clamp(0, C - 1)
    return F._replace(assign=F.assign[src], factor=rep_valid.to(torch.int64),
                      valid=rep_valid, orig=ar, lo=F.lo[src], hi=F.hi[src])


def _identity_reps(F, active: torch.Tensor):
    """Degenerate dedup: every active row is its own representative."""
    C = F.assign.shape[0]
    return F._replace(factor=active.to(torch.int64), valid=active,
                      orig=torch.arange(C, dtype=torch.int32,
                                        device=F.assign.device))


def _apply_counts(F, hit, hvals, rep_of_row, cnt):
    mult = torch.where(hit, hvals, cnt[rep_of_row.clamp(0, cnt.shape[0] - 1)])
    factor = F.factor * mult
    return F._replace(factor=factor, valid=F.valid & (factor > 0))


def _segment_counts(exit_F, n_slots: int) -> torch.Tensor:
    contrib = torch.where(exit_F.valid, exit_F.factor, 0)
    return torch.zeros(n_slots, dtype=torch.int64,
                       device=contrib.device).scatter_add_(
        0, exit_F.orig.clamp(0, n_slots - 1).long(), contrib)


def _store_blocks(slab: torch.Tensor, E, poff: torch.Tensor,
                  admit: torch.Tensor, *, d0: int, d1: int) -> None:
    """Write one exit chunk's per-representative row blocks into the slab
    arena (tier-2 payload insert, evaluation mode), in place.

    Exit rows are sorted by representative id exactly as in the replay
    step; rep *r*'s rows land contiguously at ``poff[r]``.  Refused or
    invalid rows are routed to the arena's scratch row (the last one), so
    only the scratch row ever receives duplicate destinations (on CUDA the
    order in which duplicates land is undefined) and no live row is
    written twice.
    """
    C = E.assign.shape[0]
    R = slab.shape[0] - 1  # last row = scratch
    i32 = torch.int32
    dev = E.assign.device
    eorig = E.orig.clamp(0, C - 1)
    ecnt = torch.zeros(C, dtype=i32, device=dev).scatter_add_(
        0, eorig.long(), E.valid.to(i32))
    ekey = torch.where(E.valid, eorig, C)
    eorder = torch.argsort(ekey, stable=True)
    estart = torch.cumsum(ecnt, 0, dtype=i32) - ecnt
    j = torch.arange(C, dtype=i32, device=dev)
    rep = eorig[eorder]
    ok = E.valid[eorder] & admit[rep]
    dest = torch.where(ok, (poff[rep] + (j - estart[rep])).clamp(0, R - 1),
                       R).long()
    rows = E.assign[eorder, d0:d1 + 1]
    slab[dest] = torch.where(ok[:, None], rows, slab[dest])


def _alloc_blocks_static(bump: torch.Tensor, tplen: torch.Tensor,
                         lens: torch.Tensor, cand: torch.Tensor, *,
                         cap: int):
    """The twin of :meth:`~.cache.DeviceCache.alloc_blocks` for the static
    executor, with the arena state (the 0-d int32 ``bump`` pointer and the
    ``tplen`` plane) kept on the device: bump-allocate one batch of
    variable-length slab blocks.  Same rules as the host allocator: blocks
    larger than the whole arena are refused; if the batch does not fit
    the rest of the arena and the arena is not empty, every payload is
    epoch-flushed (``tplen`` reset to -1) before admitting; candidates
    still beyond the arena are refused prefix-wise.  Returns ``(offsets,
    admitted, bump', tplen')``; the inputs are not modified."""
    lens = torch.where(cand, lens.to(torch.int32), 0)
    lens = torch.where(lens <= cap, lens, 0)
    total = lens.sum(dtype=torch.int32)
    flushed = (total > cap - bump) & (bump > 0) & (total > 0)
    bump = torch.where(flushed, 0, bump)
    tplen = torch.where(flushed, torch.full_like(tplen, -1), tplen)
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    admit = (lens > 0) & (cum <= cap - bump)
    offs = torch.where(admit, bump + cum - lens, 0).to(torch.int32)
    bump = bump + torch.where(admit, lens, 0).sum(dtype=torch.int32)
    return offs, admit, bump, tplen


# ---------------------------------------------------------------------------
# Host-driven executor
# ---------------------------------------------------------------------------


@dataclass
class _Frame:
    """Parked parent chunk of one ENTER_CHILD (the explicit chunk-stack)."""

    F: Any                       # parent chunk
    keys: Optional[torch.Tensor]
    hit: torch.Tensor
    hvals: torch.Tensor
    rep_of_row: torch.Tensor
    first_idx: Optional[torch.Tensor]
    n_reps: Optional[torch.Tensor]
    use_t1: bool
    use_t2: bool
    # evaluation-mode tier 2: per-row payload pointers of the probe hits
    poff: Optional[torch.Tensor] = None
    plen: Optional[torch.Tensor] = None


class ScheduleExecutor:
    """Execute a :class:`Schedule` over morsel chunks (host-driven).

    A recursive interpreter over the linear op list: an ENTER…FOLD
    bracket executes its interior once per parent chunk (``_exec`` on the
    bracketed slice), folds, and continues past the bracket — the op list
    is the single source of control flow; only the bracket nesting is
    walked as Python recursion (bounded by TD depth).

    * **Within an op, chunks batch.**  All chunks at an op are processed
      together, so device→host syncs are O(ops), not O(chunks): one
      planning fetch plus one batched ``valid.any()`` admission check per
      op execution, via :func:`hostsync.device_get`.
    * **Across an ENTER…FOLD span, parent chunks run sequentially.**
      Parent chunk *i*'s subtree is probed, expanded, and its results
      *inserted into the tier-2 table* before chunk *i+1* probes — the
      paper's cache[α, μ|α] reuse across morsels.

    ``mode="count"`` multiplies subtree counts into factors (tier 1 + 2);
    ``mode="evaluate"`` materializes tuples: FOLD replays representative
    row blocks through ``orig`` and EMIT packs each result chunk — drained
    one-shot by :meth:`evaluate` or streamed by :meth:`evaluate_stream`
    (blocks leave through a bounded async fetch queue as they are
    produced; with the engine's ``stream_interior`` knob on, every
    top-level parent morsel's continuations run the remaining schedule
    suffix at once).  With ``cache_payloads`` on, evaluation also uses
    tier 2: ENTER probes the payload table, hit rows skip the bag, and
    FOLD splices their cached blocks back (the splice kernel) while
    storing the miss representatives' fresh blocks.  Count-only tables
    are bypassed — caching stays an optimization, never a correctness
    requirement.
    """

    def __init__(self, engine, mode: str = "count"):
        if mode not in ("count", "evaluate"):
            raise ValueError(mode)
        self.engine = engine
        self.schedule: Schedule = engine.schedule
        self.mode = mode
        self.cache = getattr(engine, "cache", None)
        self.dedup = bool(getattr(engine, "dedup", False))
        self._bracket: Dict[int, int] = {}
        open_pcs: List[int] = []
        for pc, op in enumerate(self.schedule.ops):
            if op.kind == ENTER_CHILD:
                open_pcs.append(pc)
            elif op.kind == FOLD_CHILD:
                self._bracket[open_pcs.pop()] = pc
        dev = engine.device
        self._total = torch.zeros((), dtype=torch.int64, device=dev)
        self._t1_collapsed = torch.zeros((), dtype=torch.int64, device=dev)
        self.subtree_launches = 0
        # op-execution counters: span interiors re-run once per parent
        # morsel, so the sync budget scales with these
        self.op_runs = {"expand": 0, "span": 0, "fold": 0, "emit": 0}
        self.calls = dict.fromkeys(CALL_COUNTERS, 0)
        self._emitted: List[Tuple[Any, Any]] = []  # (packed, k) pairs
        # streaming emit: bound on in-flight device→host block copies
        self.emit_in_flight = int(getattr(engine, "emit_in_flight", 8))
        self.stream_interior = bool(getattr(engine, "stream_interior",
                                            True))
        self._stream_async = False  # set per pass by _iter_emitted
        self.emitted_blocks = 0
        self.emit_queue: Optional[AsyncFetchQueue] = None  # set by stream

    def _count_launch(self, op: str, fn, t: torch.Tensor) -> None:
        path = launch_path(fn, t)
        self.calls[f"{op}_calls_{path}"] += 1
        if op == "fold_splice":
            self.calls[f"fold_calls_{path}"] += 1

    def call_counts(self) -> Dict[str, int]:
        """Kernel launches of this pass (:data:`CALL_COUNTERS`)."""
        return dict(self.calls)

    # -- public entry points -------------------------------------------
    def count(self) -> int:
        for _ in self._iter_emitted():
            pass
        return int(device_get(self._total, "emit-total"))

    def evaluate(self) -> Iterator[np.ndarray]:
        """Yields (k, n) int32 blocks of result assignments (order cols).

        One-shot drain: blocks are buffered on device until the pass
        completes, then fetched with a single batched sync
        (``emit-rows``)."""
        for pairs in self._iter_emitted():
            self._emitted.extend(pairs)
        if not self._emitted:
            return
        blocks = device_get(self._emitted, "emit-rows")
        for packed, k in blocks:
            k = int(k)
            if k:
                yield packed[:k]

    def evaluate_stream(self) -> Iterator[np.ndarray]:
        """Streaming evaluation: yields the same (k, n) int32 blocks as
        :meth:`evaluate`, in the same order, but each block's device→host
        copy is issued asynchronously the moment the block is produced,
        through a bounded :class:`~.hostsync.AsyncFetchQueue`.  Async
        issues ride ``SyncCounter.async_count`` (label ``emit-stream``);
        the blocking-sync budget stays O(ops)."""
        # The queue persists on the ENGINE (its staging arrays survive
        # across passes); per-pass accounting resets here.
        queue = getattr(self.engine, "_emit_queue", None)
        if queue is None or queue.max_in_flight != self.emit_in_flight:
            queue = AsyncFetchQueue(self.emit_in_flight, double_buffer=True)
            self.engine._emit_queue = queue
        else:
            for _ in queue.drain():  # an abandoned prior stream's leftovers
                pass
            queue.reset()
        self.emit_queue = queue
        for pairs in self._iter_emitted(stream=True):
            for pair in pairs:
                for done in queue.put(pair, "emit-stream"):
                    row = self._materialize(done)
                    if row is not None:
                        yield row
            for done in queue.poll():
                row = self._materialize(done)
                if row is not None:
                    yield row
        for done in queue.drain():
            row = self._materialize(done)
            if row is not None:
                yield row

    @staticmethod
    def _materialize(pair: Tuple[Any, Any]) -> Optional[np.ndarray]:
        packed, k = pair
        k = int(k)
        if k == 0:
            return None
        # copy out of the fetch buffer: the double-buffered queue recycles
        # the backing host array for a later fetch
        return np.array(packed[:k])

    def t1_rows_collapsed(self) -> int:
        return int(device_get(self._t1_collapsed, "stats-t1"))

    # -- the interpreter -----------------------------------------------
    def _iter_emitted(self, stream: bool = False
                      ) -> Iterator[List[Tuple[Any, Any]]]:
        """Run the schedule; yields lists of emitted ``(packed, k)``
        device pairs (evaluate mode only; count mode yields nothing).

        With ``stream=True`` (and the engine's ``stream_interior`` knob
        on), every *top-level* parent morsel's fold continuations run the
        remaining schedule suffix the moment their fold closes, so result
        blocks reach the async emit queue while the next parent morsel
        still has device work in flight.  Per-table tier-2 probe/insert
        order is unchanged: one bracket's parent morsels still run
        sequentially, and a bracket's table is touched only by its own
        ENTER/FOLD ops."""
        forward = (stream and self.mode == "evaluate"
                   and self.stream_interior)
        # in forwarding mode the replay plans ride async issues too
        # ("replay-plan-async"): see _fold_one_evaluate
        self._stream_async = forward
        yield from self._exec([self.engine.initial_frontier()], 0,
                              len(self.schedule.ops), 0, forward)

    def _exec(self, chunks: List[Any], pc: int, end: int, depth: int,
              forward: bool):
        """Execute ``ops[pc:end]`` over ``chunks``: yields emitted block
        lists and *returns* the surviving chunks at ``end`` (a generator
        return value — callers consume it via ``yield from``)."""
        ops = self.schedule.ops
        while pc < end:
            op = ops[pc]
            if op.kind == EXPAND:
                chunks = self._op_expand(chunks, op)
                pc += 1
            elif op.kind == ENTER_CHILD:
                fold_pc = self._bracket[pc]
                if not chunks:  # nothing reaches this subtree: skip span
                    pc = fold_pc + 1
                    continue
                self.op_runs["span"] += 1
                conts: List[Any] = []
                # parent chunks run the interior SEQUENTIALLY: chunk i's
                # subtree results are inserted into tier 2 before chunk
                # i+1 probes (cross-morsel reuse within one query)
                for F in chunks:
                    frame, R = self._enter_one(F, op)
                    exits = yield from self._exec([R], pc + 1, fold_pc,
                                                  depth + 1, forward)
                    parts = self._fold_one(frame, exits, ops[fold_pc])
                    if forward and depth == 0:
                        # interior-span streaming: this morsel's
                        # continuations run the suffix now
                        yield from self._exec(
                            self._admit(parts, "fold-admit"),
                            fold_pc + 1, end, depth, forward)
                    else:
                        conts.extend(parts)
                if forward and depth == 0:
                    return []  # the suffix already ran per parent morsel
                chunks = self._admit(conts, "fold-admit")
                pc = fold_pc + 1
            else:  # EMIT
                self.op_runs["emit"] += 1
                if self.mode == "count":
                    for F in chunks:
                        self._total = self._total + torch.where(
                            F.valid, F.factor, 0).sum()
                elif chunks:
                    # pack valid rows to the front (EMIT kernel) and keep
                    # only (packed, k) — holding whole Frontiers until the
                    # fetch would keep factor/orig/lo/hi alive
                    efn = self.engine._emit_fn()
                    pairs = []
                    for F in chunks:
                        self._count_launch("emit", efn, F.assign)
                        pairs.append(efn(F.assign, F.valid))
                    self.emitted_blocks += len(pairs)
                    yield pairs
                pc += 1
        return chunks

    # -- EXPAND --------------------------------------------------------
    def _op_expand(self, chunks, op: Op):
        if not chunks:
            return []
        self.op_runs["expand"] += 1
        eng = self.engine
        d = op.d
        g_ai, rs, _ = eng.expand_plan(d)
        cap = eng.capacity
        # one planning fetch for every chunk at this op
        lo_h, hi_h, va_h = device_get(
            (torch.stack([F.lo[:, g_ai] for F in chunks]),
             torch.stack([F.hi[:, g_ai] for F in chunks]),
             torch.stack([F.valid for F in chunks])), "expand-plan")
        to_run: List[Any] = []
        oversized: List[Tuple[Any, np.ndarray]] = []
        for i, F in enumerate(chunks):
            r0 = np.searchsorted(rs, lo_h[i], side="left")
            r1 = np.searchsorted(rs, hi_h[i], side="left")
            counts = np.where(va_h[i], r1 - r0, 0).astype(np.int64)
            if int(counts.sum()) <= cap:
                to_run.append(F)
            else:
                oversized.append((F, counts))
        if oversized:
            # one batched fetch for every chunk that needs morsel splitting
            hosts = device_get([F._asdict() for F, _ in oversized],
                               "expand-split")
            for (_, counts), host in zip(oversized, hosts):
                to_run.extend(eng.split_chunk_host(host, d, counts))
        fn = eng._expand_fn(d)
        out = []
        for F in to_run:
            for key, n in expand_launches(fn, F.assign).items():
                self.calls[key] += n
            out.append(fn(F)[0])
        return self._admit(out, "expand-admit")

    # -- ENTER_CHILD (one parent chunk) --------------------------------
    def _enter_one(self, F, op: Op) -> Tuple[_Frame, Any]:
        C = self.engine.capacity
        dev = F.assign.device
        cache_on = self.cache is not None and self.cache.enabled
        # evaluation mode probes tier 2 only when row-block payloads are
        # on: count tables cannot replay tuples
        use_t2 = op.probe and cache_on and (
            self.mode == "count" or self.cache.config.cache_payloads)
        use_t1 = op.dedup and self.dedup
        keys = (_pack_keys(F.assign, op.adhesion, op.node)
                if (op.probe or op.dedup) else None)
        poff = plen = None
        if use_t2 and self.mode == "evaluate":
            # a payload hit means: splice the cached factorized block at
            # FOLD instead of descending into the bag for this row
            hit, poff, plen = self.cache.get(op.node).probe_payload(
                keys, F.valid)
            hvals = torch.zeros(C, dtype=torch.int64, device=dev)
        elif use_t2:
            hit, hvals = self.cache.get(op.node).probe(keys, F.valid)
        else:
            hit = torch.zeros(C, dtype=torch.bool, device=dev)
            hvals = torch.zeros(C, dtype=torch.int64, device=dev)
        active = F.valid & ~hit
        if use_t1:
            first_idx, rep_of_row, n_reps = _dedup(keys, active)
            self._t1_collapsed = self._t1_collapsed + (
                active.sum(dtype=torch.int64) - n_reps)
            R = _make_rep_frontier(F, first_idx, n_reps)
        else:
            first_idx, n_reps = None, None
            rep_of_row = torch.arange(C, dtype=torch.int32, device=dev)
            R = _identity_reps(F, active)
        self.subtree_launches += 1
        return _Frame(F=F, keys=keys, hit=hit, hvals=hvals,
                      rep_of_row=rep_of_row, first_idx=first_idx,
                      n_reps=n_reps, use_t1=use_t1, use_t2=use_t2,
                      poff=poff, plen=plen), R

    # -- FOLD_CHILD (one parent chunk's subtree exits) -----------------
    def _fold_one(self, fr: _Frame, exits: List[Any], op: Op) -> List[Any]:
        self.op_runs["fold"] += 1
        if self.mode == "evaluate":
            return self._fold_one_evaluate(fr, exits, op)
        C = self.engine.capacity
        cnt = torch.zeros(C, dtype=torch.int64, device=fr.F.assign.device)
        for E in exits:
            cnt = cnt + _segment_counts(E, C)
        if fr.use_t2:
            if fr.use_t1:
                rep_keys = fr.keys[fr.first_idx.clamp(0, C - 1)]
                rep_active = torch.arange(
                    C, device=cnt.device) < fr.n_reps
            else:
                rep_keys = fr.keys
                rep_active = fr.F.valid & ~fr.hit
            # insert BEFORE the next parent chunk's probe (cross-morsel
            # reuse — the entire point of tier 2 within one query)
            self.cache.get(op.node).insert(rep_keys, cnt, rep_active)
            self.cache.maybe_resize(op.node)
        return [_apply_counts(fr.F, fr.hit, fr.hvals, fr.rep_of_row, cnt)]

    def _fold_one_evaluate(self, fr: _Frame, exits: List[Any],
                           op: Op) -> List[Any]:
        use_pay = fr.use_t2
        if not exits and not use_pay:
            return []
        eng = self.engine
        C = eng.capacity
        dev = fr.F.assign.device
        d0, d1 = op.sub_first, op.sub_last
        keys_h = None
        if use_pay:
            # with tier-1 dedup off, every parent row is its own rep — the
            # store path needs the key values to collapse duplicates, so
            # they ride the same fetch (still one sync per fold)
            extra = ((fr.hit, fr.plen) if fr.use_t1
                     else (fr.hit, fr.plen, fr.keys))
        else:
            extra = ()
        pplan = (fr.rep_of_row, fr.F.valid & ~fr.hit) + extra
        if self._stream_async:
            # interior-streaming mode: the replay plan rides ASYNC issues
            # ("replay-plan-async") — one per exit chunk plus one for the
            # parent plan — so later exits' copies land while earlier
            # exits' replay launches are being enqueued
            efetches = [device_get_async((E.orig, E.valid),
                                         "replay-plan-async")
                        for E in exits]
            host = device_get_async(pplan, "replay-plan-async").get()
            exits_h: List[Any] = [None] * len(exits)
        else:
            # ONE planning fetch per fold: exit orig/valid, the parent rep
            # map and (payload mode) the probe's hit mask and block
            # lengths — O(ops) syncs
            efetches = None
            exits_h, host = device_get(
                ([(E.orig, E.valid) for E in exits], pplan), "replay-plan")
        ror_h, active_h = host[0], host[1]
        if use_pay:
            hit_h, plen_h = host[2], host[3]
            if not fr.use_t1:
                keys_h = host[4]
        active_dev = fr.F.valid & ~fr.hit
        # the replay kernel needs sorted exits (the chain does not) —
        # guaranteed here: every exit chunk is an EXPAND output or a fold
        # continuation (bracket interiors always contain >=1 EXPAND),
        # both of which are valid-prefix compacted with nondecreasing orig
        fold_replay = eng._fold_fn(d0, d1, True, False) if exits else None
        out: List[Any] = []
        ecnts: List[np.ndarray] = []
        for j, E in enumerate(exits):
            eorig, evalid = (efetches[j].get() if efetches is not None
                             else exits_h[j])
            ecnt = np.zeros(C, np.int64)
            np.add.at(ecnt, np.clip(eorig, 0, C - 1),
                      evalid.astype(np.int64))
            ecnts.append(ecnt)
            pcnt = np.where(active_h, ecnt[np.clip(ror_h, 0, C - 1)], 0)
            for mask in _pack_parent_morsels(pcnt, C):
                self._count_launch("fold", fold_replay, fr.F.assign)
                cont, _stats = fold_replay(
                    fr.F, active_dev & torch.from_numpy(mask).to(dev),
                    fr.rep_of_row, E)
                out.append(cont)
        if use_pay:
            tbl = self.cache.get(op.node)
            if hit_h.any():
                # splice FIRST: hit parents never descended into the bag;
                # their cached blocks re-expand through the splice kernel.
                # The probe's (poff, plen) pointers are only valid until
                # this table's next insert (which may epoch-flush and
                # reuse the arena rows), so the splice precedes the insert.
                fold_splice = eng._fold_fn(d0, d1, False, True)
                pcnt = np.where(hit_h, plen_h, 0).astype(np.int64)
                for mask in _pack_parent_morsels(pcnt, C):
                    self._count_launch("fold_splice", fold_splice,
                                       fr.F.assign)
                    spl, _stats = fold_splice(
                        fr.F, fr.hit & torch.from_numpy(mask).to(dev),
                        fr.poff, fr.plen, tbl.slab)
                    out.append(spl)
            # feed the store throttle from the masks this fold already
            # fetched (no extra sync): probes = hit + miss parent rows
            n_hit = int(hit_h.sum())
            tbl.note_eval_probes(n_hit + int(active_h.sum()), n_hit)
            launches0 = tbl.window_launches
            if exits:
                probation = self.cache.config.payload_probation
                if tbl.store_throttled():
                    # keys don't recur on this table — stop paying the
                    # arena writes; every Nth throttled fold still stores
                    # (probation) so the hit rate can recover
                    tbl.payload_throttled += 1
                    if probation and tbl.payload_throttled % probation == 0:
                        self._insert_payload_blocks(fr, exits, ecnts,
                                                    active_h, keys_h, op)
                else:
                    # store the miss representatives' blocks BEFORE the
                    # next parent morsel probes (cross-morsel reuse)
                    self._insert_payload_blocks(fr, exits, ecnts,
                                                active_h, keys_h, op)
            # the sizing controller keeps running while the store
            # throttle is engaged: tick its launch clock for insert-less
            # folds (throttled, or nothing eligible) before deciding
            if tbl.window_launches == launches0:
                tbl.window_launches = launches0 + 1
            self.cache.maybe_resize(op.node)
        return out

    def _insert_payload_blocks(self, fr: _Frame, exits: List[Any],
                               ecnts: List[np.ndarray], active_h,
                               keys_h: Optional[np.ndarray], op: Op
                               ) -> None:
        """Tier-2 payload insert at FOLD (evaluation mode): slab-write the
        representatives' row blocks and admit their keys.

        A block is admitted from exit chunk *j* exactly when all of its
        rep's exit rows are in chunk *j* (``ecnt_j == total``): a rep
        spread over several chunks would cache a partial result, and is
        skipped (that only costs recomputation)."""
        tbl = self.cache.get(op.node)
        C = self.engine.capacity
        dev = fr.F.assign.device
        total = ecnts[0] if len(ecnts) == 1 else np.sum(ecnts, axis=0)
        if fr.use_t1:
            # valid reps are exactly the rows ecnt can be nonzero at
            rep_keys = fr.keys[fr.first_idx.clamp(0, C - 1)]
            eligible = total > 0
        else:
            rep_keys = fr.keys
            eligible = (total > 0) & active_h
            if keys_h is not None:
                # dedup off: duplicate adhesion keys each carry their own
                # (identical) block, but only one copy per key can be
                # admitted — keep the first, or the rest leak arena rows
                big = np.int64(2 ** 62)
                k = np.where(eligible, keys_h, big)
                order = np.argsort(k, kind="stable")
                ks = k[order]
                isfirst = np.ones(ks.shape[0], bool)
                isfirst[1:] = ks[1:] != ks[:-1]
                isfirst &= ks != big
                first = np.zeros_like(eligible)
                first[order[isfirst]] = True
                eligible &= first
        stored = np.zeros(C, bool)
        poff_all = np.zeros(C, np.int32)
        flushes0 = tbl.payload_flushes
        for E, ecnt in zip(exits, ecnts):
            cand = eligible & (ecnt == total)
            if not cand.any():
                continue  # empty subtrees are not cached (no negatives)
            tbl.ensure_slab(op.sub_last - op.sub_first + 1)
            poff_np, admit_np = tbl.alloc_blocks(ecnt, cand)
            if tbl.payload_flushes != flushes0:
                # an epoch flush rewound the arena mid-fold: offsets from
                # earlier chunks may now be overwritten — drop them from
                # the batched admission (recompute later)
                stored[:] = False
                flushes0 = tbl.payload_flushes
            if not admit_np.any():
                continue
            _store_blocks(tbl.slab, E, torch.from_numpy(poff_np).to(dev),
                          torch.from_numpy(admit_np).to(dev),
                          d0=op.sub_first, d1=op.sub_last)
            poff_all = np.where(admit_np, poff_np, poff_all)
            stored |= admit_np
        if stored.any():
            # one batched key admission for the whole fold (a rep is
            # complete in at most one chunk, so the admit sets are
            # disjoint); vals = block length = the exact subtree count
            # (factors are all 1 in evaluation mode), so count() can
            # reuse the entries
            lens = torch.from_numpy(total).to(dev)
            tbl.insert(rep_keys, lens, torch.from_numpy(stored).to(dev),
                       poff=torch.from_numpy(poff_all).to(dev),
                       plen=lens.to(torch.int32))
        tbl.payload_skips += int((eligible & ~stored).sum())

    # -- shared --------------------------------------------------------
    def _admit(self, out, label: str):
        """Drop empty chunks with ONE batched host sync for the whole op."""
        if not out:
            return []
        keep = device_get(torch.stack([F.valid.any() for F in out]), label)
        return [F for F, k in zip(out, keep) if k]


def _pack_parent_morsels(pcnt: np.ndarray, cap: int) -> List[np.ndarray]:
    """Greedy-pack parent rows into masks whose total replay size fits one
    chunk.  A single parent's pair count is <= the exit chunk's valid rows
    <= cap, so packing always succeeds."""
    masks: List[np.ndarray] = []
    cur = np.zeros(pcnt.shape[0], bool)
    acc = 0
    for i in np.flatnonzero(pcnt > 0):
        c = int(pcnt[i])
        if acc and acc + c > cap:
            masks.append(cur)
            cur = np.zeros(pcnt.shape[0], bool)
            acc = 0
        cur[i] = True
        acc += c
    if acc:
        masks.append(cur)
    return masks


# ---------------------------------------------------------------------------
# Static (fixed-capacity) executor
# ---------------------------------------------------------------------------


def _sort_exits(E):
    """The exit chunk stably sorted by ``ekey = valid ? clip(orig) : C``:
    valid rows to the front in nondecreasing ``orig``, each
    representative's rows in their original order — row for row what the
    reference's XLA FOLD gathers through its ``eorder``."""
    C = E.assign.shape[0]
    ekey = torch.where(E.valid, E.orig.clamp(0, C - 1), C)
    perm = torch.sort(ekey, stable=True).indices
    return type(E)(*(x[perm] for x in E))


def execute_static(schedule: Schedule, engine, F0, tables: Dict[int, tuple],
                   cfg, mode: str = "count",
                   counts: Optional[Dict[str, Any]] = None):
    """Run ``schedule`` as one fixed-capacity pass with no host sync.

    Every op runs once, on one chunk of the engine's capacity C: a chunk
    that would need more rows is truncated and the pass's overflow flag is
    set (the flag is honest: every EXPAND's ``needed`` and all three
    figures of a merged FOLD's stats are checked against C).  Tier-2
    tables are threaded through the pass: ``tables[c]`` is the count-only
    ``(keys, vals, used, stamp, cost)`` tuple of ``core/cache.py`` or the
    payload-capable 9-tuple extending it with ``(pay_off, pay_len, slab,
    bump)``, ``bump`` a 0-d int32 device tensor, so slab allocation and
    its epoch flush stay on the device (:func:`_alloc_blocks_static`).
    The table planes are replaced, as in the reference; the **slab is
    written in place** (:func:`_store_blocks`), so a slab passed in is the
    slab returned, updated.  The LRU tick is a Python int counted up op by
    op, as the reference unrolls it.

    ``mode="count"`` returns ``(count, overflow, tables)``;
    ``mode="evaluate"`` returns ``(assign, valid, count, overflow,
    replay_hits, tables)``, ``(assign, valid)`` the result chunk with the
    valid rows packed to the front by the EMIT kernel.  All results are
    device tensors.  In evaluation, FOLD replays the miss representatives
    through ``orig`` and, on a payload table, splices the hit rows'
    cached blocks into the same chunk: one merged FOLD kernel, then the
    miss representatives' blocks are stored.  Count-only tables are
    bypassed in evaluation (optionality); with tier-1 dedup off only the
    first occurrence of a duplicate key may store its block.

    The FOLD kernels (``fold_kernel="fused"``) need the exit chunk sorted
    by ``orig``.  The pass tracks that as the reference does: the initial
    chunk and every representative chunk are sorted, EXPAND and a
    replay-only FOLD keep their input's order, a merged FOLD's output is
    two sorted regions.  Under ``"fused"`` an exit chunk that is not
    sorted is stably sorted on the device first (:func:`_sort_exits`) and
    goes to the same kernel; the chain (``fold_kernel="chain"``) takes
    the exits as they come and sorts them itself, as the reference routes
    such a fold to its XLA chain.  Both give the same rows.

    ``counts``, when given, receives the pass's kernel launches per path
    (``expand_calls_cuda`` …, chain EXPANDs and their bound calls as
    :func:`expand_launches` counts them, ``fold_merged_calls_*`` for the
    merged arity, which ``fold_calls_*`` also counts; the op chains as
    ``*_calls_chain``; the tier-2 table ops, by :func:`path_of`, as
    ``tier2_probe_calls_*`` and ``tier2_insert_calls_*``),
    ``fold_sorted_exits`` (the fused folds that
    sorted their exits first) and ``needed_max`` (a 0-d device
    tensor: the most rows any op of the pass needed, a merged FOLD's
    replay and splice rows together).  With tracing on
    (:func:`trace.enable`), each op runs in its ``ctj.*`` span and
    ``counts`` also receives the pass's row counters, 0-d int64 device
    tensors (:data:`ROW_COUNTERS`): ``tier2_probes`` (valid rows probed),
    ``tier2_hits``, ``tier2_inserts`` (representatives offered),
    ``tier1_rows_entered`` (active rows at the ENTERs that dedup),
    ``tier1_rows_collapsed`` (those less their representatives) and
    ``expand_rows`` (the sum of every EXPAND's ``needed``).  Tracing off,
    none of them is computed.
    """
    from .cache import (_insert as cache_insert, _probe as cache_probe,
                        _probe_payload as cache_probe_payload)
    if mode not in ("count", "evaluate"):
        raise ValueError(mode)
    C = engine.capacity
    dev = F0.assign.device
    i32, i64 = torch.int32, torch.int64
    counts = {} if counts is None else counts
    for op_name in ("expand", "fold", "fold_merged", "emit"):
        for path in ("cuda", "torch", "chain"):
            counts.setdefault(f"{op_name}_calls_{path}", 0)
    for op_name in ("tier2_probe", "tier2_insert"):
        for path in ("cuda", "torch"):
            counts.setdefault(f"{op_name}_calls_{path}", 0)
    counts.setdefault("fold_sorted_exits", 0)

    def launched(op_name: str, fn, t: torch.Tensor) -> None:
        counts[f"{op_name}_calls_{launch_path(fn, t)}"] += 1

    def tier2_call(op_name: str, t: torch.Tensor) -> None:
        counts[f"tier2_{op_name}_calls_{path_of(t)}"] += 1

    F = F0
    ov = torch.zeros((), dtype=torch.bool, device=dev)
    needed_max = torch.zeros((), dtype=i64, device=dev)
    stack: List[tuple] = []
    tick = 0
    total = torch.zeros((), dtype=i64, device=dev)
    n_replay = torch.zeros((), dtype=i64, device=dev)
    rows = rvalid = None
    ar = torch.arange(C, dtype=i32, device=dev)
    # the FOLD kernels' sorted-exits precondition, tracked as the
    # reference tracks it: F0's orig is constant (sorted); ENTER resets
    # the flag (rep chunks carry orig = arange); EXPAND keeps its input's
    # order; a replay-only fold's output is sorted iff its parent was; a
    # merged output is two sorted regions, not sorted as a whole
    sorted_now = True
    # with tracing on: one span an op, and the pass's row counters as 0-d
    # device tensors in ``counts`` (never evaluated with tracing off)
    tracing = trace.enabled()
    span = trace.span

    def tally(key: str, n: torch.Tensor) -> None:
        counts[key] = counts[key] + n if key in counts else n

    for op in schedule.ops:
        if op.kind == EXPAND:
            with span("ctj.expand"):
                fn = engine._expand_fn(op.d)
                for key, n in expand_launches(fn, F.assign).items():
                    counts[key] = counts.get(key, 0) + n
                F, needed = fn(F)
                ov = ov | (needed > C)
                needed_max = torch.maximum(needed_max, needed.to(i64))
                if tracing:
                    tally("expand_rows", needed.to(i64))
        elif op.kind == ENTER_CHILD:
            with span("ctj.enter"):
                keys = (_pack_keys(F.assign, op.adhesion, op.node)
                        if (op.probe or op.dedup) else None)
                tbl = tables.get(op.node)
                has_pay = tbl is not None and len(tbl) > 5
                # evaluation probes tier 2 only on payload tables:
                # count-only entries cannot replay tuples (optionality)
                use_t2 = op.probe and tbl is not None and (
                    mode == "count" or has_pay)
                poff = plen = None
                if use_t2:
                    with span("ctj.tier2.probe"):
                        tick += 1
                        tier2_call("probe", keys)
                        if mode == "evaluate":
                            tk, tv, tu, ts, tc, tpoff, tplen, slab, bump = tbl
                            hit, poff, plen, ts = cache_probe_payload(
                                tk, tu, ts, tpoff, tplen, keys, F.valid, tick)
                            hvals = torch.zeros(C, dtype=i64, device=dev)
                            n_replay = n_replay + hit.sum(dtype=i64)
                            tables = dict(tables)
                            tables[op.node] = (tk, tv, tu, ts, tc, tpoff,
                                               tplen, slab, bump)
                        else:
                            tk, tv, tu, ts, tc = tbl[:5]
                            hit, hvals, ts = cache_probe(tk, tv, tu, ts, keys,
                                                         F.valid, tick)
                            tables = dict(tables)
                            tables[op.node] = ((tk, tv, tu, ts, tc)
                                               + tuple(tbl[5:]))
                        if tracing:
                            tally("tier2_probes", F.valid.sum(dtype=i64))
                            tally("tier2_hits", hit.sum(dtype=i64))
                else:
                    hit = torch.zeros(C, dtype=torch.bool, device=dev)
                    hvals = torch.zeros(C, dtype=i64, device=dev)
                active = F.valid & ~hit
                with span("ctj.tier1.dedup"):
                    if op.dedup:
                        first_idx, rep_of_row, n_reps = _dedup(keys, active)
                        if tracing:
                            entered = active.sum(dtype=i64)
                            tally("tier1_rows_entered", entered)
                            tally("tier1_rows_collapsed", entered - n_reps)
                        R = _make_rep_frontier(F, first_idx, n_reps)
                    else:
                        first_idx, n_reps = None, None
                        rep_of_row = ar
                        R = _identity_reps(F, active)
                stack.append((F, keys, hit, hvals, rep_of_row, first_idx,
                              n_reps, active, use_t2, poff, plen, sorted_now))
                F = R
                sorted_now = True  # rep chunks carry orig = arange
        elif op.kind == FOLD_CHILD:
            with span("ctj.fold"):
                (P, keys, hit, hvals, rep_of_row, first_idx, n_reps, active,
                 use_t2, poff, plen, parent_sorted) = stack.pop()
                if mode == "evaluate":
                    E = F
                    d0, d1 = op.sub_first, op.sub_last
                    ffn = engine._fold_fn(d0, d1, True, use_t2)
                    if not sorted_now and ffn.path == "fused":
                        E = _sort_exits(E)
                        counts["fold_sorted_exits"] += 1
                    launched("fold", ffn, P.assign)
                    if use_t2:
                        (tk, tv, tu, ts, tc, tpoff, tplen, slab,
                         bump) = tables[op.node]
                        # the splice reads the probed blocks BEFORE this
                        # table's store below (an epoch flush may reuse
                        # their arena rows); stream order keeps that on the
                        # card.  Everything replays and splices at once, so
                        # all three stats figures are checked against C
                        launched("fold_merged", ffn, P.assign)
                        F, stats = ffn(P, active, rep_of_row, E, hit, poff,
                                       plen, slab)
                        ov = ov | (stats > C).any()
                        needed_max = torch.maximum(needed_max,
                                                   stats[0] + stats[1])
                        sorted_now = False  # two sorted regions
                        with span("ctj.tier2.insert"):
                            # store the miss representatives' blocks: one
                            # exit chunk, so every block is complete
                            ecnt = torch.zeros(C, dtype=i32, device=dev
                                               ).scatter_add_(
                                0, E.orig.clamp(0, C - 1).long(),
                                E.valid.to(i32))
                            if op.dedup:
                                rep_keys = keys[first_idx.clamp(0, C - 1)]
                                eligible = (ecnt > 0) & (ar < n_reps)
                            else:
                                rep_keys = keys
                                eligible = (ecnt > 0) & active
                                # duplicate adhesion keys: only the first
                                # occurrence may store, or the rest leak
                                # arena rows
                                fi, _, nr = _dedup(keys, eligible)
                                isrep = torch.zeros(C, dtype=i32, device=dev
                                                    ).scatter_reduce_(
                                    0, fi.clamp(0, C - 1).long(),
                                    (ar < nr).to(i32), "amax")
                                eligible = eligible & (isrep > 0)
                            if tracing:
                                tally("tier2_inserts",
                                      eligible.sum(dtype=i64))
                            offs, admit, bump, tplen = _alloc_blocks_static(
                                bump, tplen, ecnt, eligible,
                                cap=int(cfg.payload_rows))
                            _store_blocks(slab, E, offs, admit, d0=d0, d1=d1)
                            tick += 1
                            tier2_call("insert", rep_keys)
                            lens = ecnt.to(i64)
                            out = cache_insert(
                                tk, tv, tu, ts, tc, rep_keys, lens,
                                torch.clamp(lens, min=1), admit, tick,
                                policy=cfg.policy, rounds=min(cfg.ways, 8),
                                pay=(tpoff, tplen, offs, ecnt))
                            tables = dict(tables)
                            tables[op.node] = tuple(out[:7]) + (slab, bump)
                    else:
                        F, stats = ffn(P, active, rep_of_row, E)
                        ov = ov | (stats[0] > C)
                        needed_max = torch.maximum(needed_max, stats[0])
                        # the continuation keeps the parent's row order
                        sorted_now = parent_sorted
                else:
                    cnt = _segment_counts(F, C)
                    sorted_now = parent_sorted  # _apply_counts keeps order
                    if use_t2:
                        with span("ctj.tier2.insert"):
                            if op.dedup:
                                rep_keys = keys[first_idx.clamp(0, C - 1)]
                                rep_active = ar < n_reps
                            else:
                                rep_keys, rep_active = keys, active
                            if tracing:
                                tally("tier2_inserts",
                                      rep_active.sum(dtype=i64))
                            tbl = tables[op.node]
                            tick += 1
                            tier2_call("insert", rep_keys)
                            if len(tbl) > 5:
                                # a payload table in count mode: the count
                                # insert writes the -1 sentinel into the
                                # payload planes, so an eviction never
                                # leaves a stale block reachable
                                tpoff, tplen, slab, bump = tbl[5:]
                                out = cache_insert(
                                    *tbl[:5], rep_keys, cnt,
                                    torch.clamp(cnt, min=1), rep_active,
                                    tick, policy=cfg.policy,
                                    rounds=min(cfg.ways, 8),
                                    pay=(tpoff, tplen,
                                         torch.zeros(C, dtype=i32,
                                                     device=dev),
                                         torch.full((C,), -1, dtype=i32,
                                                    device=dev)))
                                new_tbl = tuple(out[:7]) + (slab, bump)
                            else:
                                out = cache_insert(*tbl, rep_keys, cnt,
                                                   torch.clamp(cnt, min=1),
                                                   rep_active, tick,
                                                   policy=cfg.policy,
                                                   rounds=min(cfg.ways, 8))
                                new_tbl = tuple(out[:5])
                            tables = dict(tables)
                            tables[op.node] = new_tbl
                    F = _apply_counts(P, hit, hvals, rep_of_row, cnt)
        else:  # EMIT
            with span("ctj.emit"):
                if mode == "count":
                    total = torch.where(F.valid, F.factor, 0).sum()
                else:
                    # valid rows to the front: the result mask becomes a
                    # prefix predicate
                    efn = engine._emit_fn()
                    launched("emit", efn, F.assign)
                    rows, k = efn(F.assign, F.valid)
                    rvalid = ar < k
                    total = k.to(i64)
    counts["needed_max"] = needed_max
    if mode == "count":
        return total, ov, tables
    return rows, rvalid, total, ov, n_replay, tables
