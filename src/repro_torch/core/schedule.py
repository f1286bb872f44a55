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
                           intermediates, materialized)
  * ``EMIT``             — accumulate counts / pack result tuples

The TD recursion is flattened at lowering time: a subtree's ops are *data*
(a bracketed ``ENTER … FOLD`` span in the op list), not Python call frames.
:class:`ScheduleExecutor` is the host-driven engine: morsel splitting, the
tier-2 cache (``core/cache.py``), batched chunk admission so host syncs
happen at most once per op execution (not per chunk — every sync is routed
through :mod:`hostsync`), while parent morsels still run an ENTER…FOLD
span sequentially so later morsels hit earlier morsels' tier-2 inserts.
EXPAND, the evaluation-mode FOLD replay and the EMIT pack are kernels
behind ``kernels/registry.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.registry import path_of
from .hostsync import device_get

MAX_KEY_BITS = 21  # packed adhesion keys: values must fit in 21 bits

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
    row blocks through ``orig`` and EMIT packs each result chunk; the
    packed blocks stay on the device until the pass completes and are
    fetched with one batched sync.  Evaluation does not use tier 2
    (count tables cannot replay tuples — caching stays an optimization,
    never a correctness requirement).
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
        # kernel launches per path ("cuda" | "torch", registry.path_of)
        self.path_runs = {op: {"cuda": 0, "torch": 0}
                          for op in ("expand", "fold", "emit")}
        self._emitted: List[Tuple[Any, Any]] = []  # (packed, k) pairs

    def _count_launch(self, op: str, t: torch.Tensor) -> None:
        self.path_runs[op][path_of(t)] += 1

    def call_counts(self) -> Dict[str, int]:
        return {f"{op}_calls_{path}": n
                for op, runs in self.path_runs.items()
                for path, n in runs.items()}

    # -- public entry points -------------------------------------------
    def count(self) -> int:
        self._exec([self.engine.initial_frontier()], 0,
                   len(self.schedule.ops))
        return int(device_get(self._total, "emit-total"))

    def evaluate(self) -> Iterator[np.ndarray]:
        """Yields (k, n) int32 blocks of result assignments (order cols).

        One-shot drain: blocks are buffered on device until the pass
        completes, then fetched with a single batched sync
        (``emit-rows``)."""
        self._exec([self.engine.initial_frontier()], 0,
                   len(self.schedule.ops))
        if not self._emitted:
            return
        blocks = device_get(self._emitted, "emit-rows")
        for packed, k in blocks:
            k = int(k)
            if k:
                yield packed[:k]

    def t1_rows_collapsed(self) -> int:
        return int(device_get(self._t1_collapsed, "stats-t1"))

    # -- the interpreter -----------------------------------------------
    def _exec(self, chunks: List[Any], pc: int, end: int) -> List[Any]:
        """Execute ``ops[pc:end]`` over ``chunks``; returns the surviving
        chunks at ``end`` (evaluation mode collects EMIT blocks in
        ``_emitted``)."""
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
                conts: List[Any] = []
                # parent chunks run the interior SEQUENTIALLY: chunk i's
                # subtree results are inserted into tier 2 before chunk
                # i+1 probes (cross-morsel reuse within one query)
                for F in chunks:
                    frame, R = self._enter_one(F, op)
                    exits = self._exec([R], pc + 1, fold_pc)
                    conts.extend(self._fold_one(frame, exits, ops[fold_pc]))
                chunks = self._admit(conts, "fold-admit")
                pc = fold_pc + 1
            else:  # EMIT
                if self.mode == "count":
                    for F in chunks:
                        self._total = self._total + torch.where(
                            F.valid, F.factor, 0).sum()
                elif chunks:
                    # pack valid rows to the front (EMIT kernel) and keep
                    # only (packed, k) — holding whole Frontiers until the
                    # fetch would keep factor/orig/lo/hi alive
                    efn = self.engine._emit_fn()
                    for F in chunks:
                        self._count_launch("emit", F.assign)
                        self._emitted.append(efn(F.assign, F.valid))
                pc += 1
        return chunks

    # -- EXPAND --------------------------------------------------------
    def _op_expand(self, chunks, op: Op):
        if not chunks:
            return []
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
            self._count_launch("expand", F.assign)
            out.append(fn(F)[0])
        return self._admit(out, "expand-admit")

    # -- ENTER_CHILD (one parent chunk) --------------------------------
    def _enter_one(self, F, op: Op) -> Tuple[_Frame, Any]:
        C = self.engine.capacity
        dev = F.assign.device
        cache_on = self.cache is not None and self.cache.enabled
        # evaluation mode bypasses tier 2: count tables cannot replay
        # tuples
        use_t2 = op.probe and cache_on and self.mode == "count"
        use_t1 = op.dedup and self.dedup
        keys = (_pack_keys(F.assign, op.adhesion, op.node)
                if (op.probe or op.dedup) else None)
        if use_t2:
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
                      n_reps=n_reps, use_t1=use_t1, use_t2=use_t2), R

    # -- FOLD_CHILD (one parent chunk's subtree exits) -----------------
    def _fold_one(self, fr: _Frame, exits: List[Any], op: Op) -> List[Any]:
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
        if not exits:
            return []
        eng = self.engine
        C = eng.capacity
        active_dev = fr.F.valid & ~fr.hit
        # ONE planning fetch per fold: exit orig/valid and the parent rep
        # map — O(ops) syncs
        exits_h, (ror_h, active_h) = device_get(
            ([(E.orig, E.valid) for E in exits],
             (fr.rep_of_row, active_dev)), "replay-plan")
        # the replay kernel needs sorted exits — guaranteed here: every
        # exit chunk is an EXPAND output or a fold continuation (bracket
        # interiors always contain >=1 EXPAND), both of which are
        # valid-prefix compacted with nondecreasing orig
        fold_replay = eng._fold_fn(op.sub_first, op.sub_last)
        out: List[Any] = []
        for E, (eorig, evalid) in zip(exits, exits_h):
            ecnt = np.zeros(C, np.int64)
            np.add.at(ecnt, np.clip(eorig, 0, C - 1), evalid.astype(np.int64))
            pcnt = np.where(active_h, ecnt[np.clip(ror_h, 0, C - 1)], 0)
            for mask in _pack_parent_morsels(pcnt, C):
                self._count_launch("fold", fr.F.assign)
                cont, _stats = fold_replay(
                    fr.F, active_dev & torch.from_numpy(mask).to(
                        active_dev.device), fr.rep_of_row, E)
                out.append(cont)
        return out

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
