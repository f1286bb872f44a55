"""Vectorized (level-synchronous) trie join in PyTorch.

The depth-first LFTJ recursion is re-derived as breadth-first *frontier
expansion*: a frontier is a fixed-capacity matrix of partial assignments
(plus per-atom trie ranges); expanding variable ``x_d`` enumerates, for
every row, the distinct candidate values of a *guard* atom (via
precomputed run-start arrays — the columnar trie) and verifies membership
in every other participating atom with batched bounded binary search.
The expansion step is a kernel behind ``kernels/registry.py``, on the
path ``expand_kernel`` names: ``"fused"`` (the default) runs the EXPAND
kernel (the CUDA kernel on a CUDA chunk, its plain torch version on a CPU
chunk); ``"chain"`` runs the op chain of ``kernels/expand/chain.py``,
whose bounded searches are of flavour ``impl`` (``"bsearch"``, or
``"leapfrog"``: the leapfrog kernel).  ``fold_kernel`` and
``emit_kernel`` pick the evaluation-mode FOLD and EMIT paths the same
way: ``"fused"`` (the kernels) or ``"chain"`` (the op chains of
``kernels/fold/chain.py`` and ``kernels/emit/chain.py``).  The static
chunk capacity bounds device memory per launch (each morsel is one
fixed-shape chunk).

This class owns the *data plane* (tries, guard selection, the expansion
step, morsel splitting); control flow — which op runs when, chunk
admission, count/evaluate emission — is ``core/schedule.py``'s
:class:`~.schedule.ScheduleExecutor` interpreting the lowered op list.

Engines run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without CUDA the default raises.  Dtypes are pinned:
``assign``/``orig``/``lo``/``hi`` int32, ``factor`` int64, ``valid`` bool.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import registry as kernels
from . import trace
from .cq import CQ
from .db import Database
from .schedule import MAX_KEY_BITS, ScheduleExecutor, lower

__all__ = ["MAX_KEY_BITS", "Frontier", "AtomLevel", "TrieJoin",
           "resolve_device", "KERNEL_PATHS", "IMPLS"]

KERNEL_PATHS = kernels.KERNEL_PATHS        # "fused" | "chain"
IMPLS = ("bsearch", "leapfrog")            # the chain's bounded search


def resolve_device(device) -> torch.device:
    """The engine's device; a CUDA device without CUDA raises (nothing
    carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Frontier(NamedTuple):
    """One fixed-capacity chunk of partial assignments (a morsel)."""

    assign: torch.Tensor   # (C, n) int32 — assignment columns (valid prefix)
    factor: torch.Tensor   # (C,)  int64 — carried count factor (paper's f)
    valid: torch.Tensor    # (C,)  bool
    orig: torch.Tensor     # (C,)  int32 — origin row for segment aggregation
    lo: torch.Tensor       # (C, m) int32 — per-atom trie range start
    hi: torch.Tensor       # (C, m) int32 — per-atom trie range end


@dataclass(frozen=True)
class AtomLevel:
    """Columnar trie level: value column + run-start index (CSR)."""

    col: torch.Tensor        # (N,) int32 — rows[:, level]
    runstarts: torch.Tensor  # (R,) int32 — positions where rows[:, :level+1] changes
    runstarts_np: np.ndarray


def _build_levels(rows: np.ndarray, device: torch.device) -> List[AtomLevel]:
    n, k = rows.shape
    levels = []
    for l in range(k):
        if n == 0:
            rs = np.zeros(0, dtype=np.int32)
        else:
            prefix = rows[:, :l + 1]
            change = np.ones(n, dtype=bool)
            change[1:] = (prefix[1:] != prefix[:-1]).any(axis=1)
            rs = np.flatnonzero(change).astype(np.int32)
        col = np.ascontiguousarray(rows[:, l].astype(np.int32))
        levels.append(AtomLevel(torch.from_numpy(col).to(device),
                                torch.from_numpy(rs).to(device), rs))
    return levels


class TrieJoin:
    """Vectorized LFTJ: count / evaluate a full CQ over a fixed order."""

    def __init__(self, q: CQ, order: Sequence[str], db: Database,
                 capacity: int = 1 << 17, device="cuda",
                 emit_in_flight: int = 8, stream_interior: bool = True,
                 impl: str = "bsearch", expand_kernel: str = "fused",
                 fold_kernel: str = "fused", emit_kernel: str = "fused"):
        for knob, path in (("expand_kernel", expand_kernel),
                           ("fold_kernel", fold_kernel),
                           ("emit_kernel", emit_kernel)):
            if path not in KERNEL_PATHS:
                raise ValueError(f"{knob} must be one of {KERNEL_PATHS}, "
                                 f"got {path!r}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.device = resolve_device(device)
        self.impl = impl
        self.expand_kernel = expand_kernel
        self.fold_kernel = fold_kernel
        self.emit_kernel = emit_kernel
        # depth -> the EXPAND path built for it (as the reference records
        # the path its registry resolved)
        self.expand_paths: Dict[int, str] = {}
        # streaming-emit bound: max in-flight device→host result-block
        # copies, consumed by ScheduleExecutor.  With ``stream_interior``
        # (the default) evaluate_stream also forwards each top-level
        # parent morsel's fold continuations through the remaining
        # schedule suffix at once
        self.emit_in_flight = int(emit_in_flight)
        self.stream_interior = bool(stream_interior)
        self.q = q
        self.order = tuple(order)
        self.n = len(self.order)
        self.db = db
        self.capacity = int(capacity)
        pos = {x: i for i, x in enumerate(self.order)}

        # per-atom tries, variables permuted into global order
        self.atom_rows: List[np.ndarray] = []
        self.atom_vars: List[Tuple[str, ...]] = []
        for a in q.atoms:
            uniq, first_col = [], {}
            for c, v in enumerate(a.vars):
                if v not in first_col:
                    first_col[v] = c
                    uniq.append(v)
            ordered = tuple(sorted(uniq, key=pos.get))
            rows = db.relations[a.relation]
            for c, v in enumerate(a.vars):
                if first_col[v] != c:
                    rows = rows[rows[:, c] == rows[:, first_col[v]]]
            rows = np.unique(rows[:, [first_col[v] for v in ordered]], axis=0)
            if rows.size and int(rows.max()) >= (1 << 31) - 1:
                raise ValueError("values must fit int32")
            self.atom_rows.append(rows.astype(np.int64))
            self.atom_vars.append(ordered)
        self.m = len(q.atoms)
        self.levels: List[List[AtomLevel]] = [
            _build_levels(r, self.device) for r in self.atom_rows]
        self.sizes = [r.shape[0] for r in self.atom_rows]

        # participants per depth; guard = the atom whose trie has the
        # DEEPEST bound prefix (most selective sibling list — LFTJ's seek
        # discipline), tie-broken by smaller relation.  Choosing by relation
        # size alone can pick an unconstrained level-0 iterator and blow the
        # frontier up by the whole value domain.
        self.at_depth: List[List[Tuple[int, int]]] = []
        self.guard: List[int] = []
        for x in self.order:
            parts = [(ai, self.atom_vars[ai].index(x))
                     for ai in range(self.m) if x in self.atom_vars[ai]]
            if not parts:
                raise ValueError(f"variable {x} not covered")
            self.at_depth.append(parts)
            scores = [lvl * (1 << 40) - self.sizes[ai] for ai, lvl in parts]
            self.guard.append(int(np.argmax(scores)))
        self._expand_fns: Dict[int, object] = {}
        self._fold_fns: Dict[Tuple[int, int, bool, bool], object] = {}
        self._emit: object = None
        # vanilla LFTJ lowers to the trivial schedule: EXPAND over every
        # depth, then EMIT (subclasses re-lower with their TD plan)
        self.schedule = lower(self.n)

    # ------------------------------------------------------------------
    def initial_frontier(self) -> Frontier:
        C, n, m, dev = self.capacity, self.n, self.m, self.device
        with trace.span("ctj.initial_frontier"):
            hi = torch.zeros((C, m), dtype=torch.int32)
            hi[0, :] = torch.tensor(self.sizes, dtype=torch.int32)
            factor = torch.zeros(C, dtype=torch.int64)
            factor[0] = 1
            valid = torch.zeros(C, dtype=torch.bool)
            valid[0] = True
            return Frontier(
                assign=torch.zeros((C, n), dtype=torch.int32, device=dev),
                factor=factor.to(dev), valid=valid.to(dev),
                orig=torch.zeros(C, dtype=torch.int32, device=dev),
                lo=torch.zeros((C, m), dtype=torch.int32, device=dev),
                hi=hi.to(dev))

    # ------------------------------------------------------------------
    def _expand_fn(self, d: int):
        """The registry-built expansion step for depth d, on the
        ``expand_kernel`` path (recorded in ``expand_paths[d]``)."""
        fn = self._expand_fns.get(d)
        if fn is None:
            args = self.expand_kernel_args(d)
            spec = kernels.ExpandSpec(
                capacity=self.capacity, n_vars=self.n, n_atoms=self.m,
                n_others=len(args["other_ais"]))
            fn = self._expand_fns[d] = kernels.expand_fn(
                spec, path=self.expand_kernel, impl=self.impl, **args)
            self.expand_paths[d] = fn.path
        return fn

    def expand_kernel_args(self, d: int) -> Dict:
        """The per-depth kernel arguments derived from the columnar tries
        (the single source the registry and tests build EXPAND(d) from)."""
        parts = self.at_depth[d]
        gi = self.guard[d]
        g_ai, g_lvl = parts[gi]
        g = self.levels[g_ai][g_lvl]
        others = tuple((ai, lvl) for k, (ai, lvl) in enumerate(parts)
                       if k != gi)
        return dict(d=d, g_ai=g_ai,
                    other_ais=tuple(ai for ai, _ in others),
                    g_col=g.col, g_rs=g.runstarts,
                    other_cols=tuple(self.levels[ai][lvl].col
                                     for ai, lvl in others),
                    n_rows_g=self.sizes[g_ai])

    def _fold_fn(self, d0: int, d1: int, with_replay: bool,
                 with_splice: bool):
        """The registry-built FOLD step for bracket [d0, d1] in the arity
        the flags select: replay-only, splice-only, or merged (both flags;
        the static executor's), on the ``fold_kernel`` path."""
        key = (d0, d1, with_replay, with_splice)
        fn = self._fold_fns.get(key)
        if fn is None:
            spec = kernels.FoldSpec(capacity=self.capacity, n_vars=self.n,
                                    n_atoms=self.m)
            fn = self._fold_fns[key] = kernels.fold_fn(
                spec, path=self.fold_kernel, d0=d0, d1=d1,
                with_replay=with_replay, with_splice=with_splice)
        return fn

    def _emit_fn(self):
        """The registry-built EMIT pack ``(assign, valid) -> (packed, k)``,
        on the ``emit_kernel`` path."""
        if self._emit is None:
            self._emit = kernels.emit_fn(
                kernels.EmitSpec(capacity=self.capacity, n_vars=self.n),
                path=self.emit_kernel)
        return self._emit

    def call_counts(self) -> Dict[str, int]:
        """Kernel launches per path of the last execution, as
        ``{"expand_calls_cuda": n, "expand_calls_torch": n, ...}``
        (:data:`~.schedule.CALL_COUNTERS`)."""
        ex = getattr(self, "last_executor", None)
        return {} if ex is None else ex.call_counts()

    # ------------------------------------------------------------------
    def expand_plan(self, d: int) -> Tuple[int, np.ndarray, int]:
        """Host-side planning arrays for depth d's guard: the executor
        fetches (lo, hi, valid) once per op and derives candidate counts
        for morsel admission/splitting from these."""
        parts = self.at_depth[d]
        g_ai, g_lvl = parts[self.guard[d]]
        return g_ai, self.levels[g_ai][g_lvl].runstarts_np, self.sizes[g_ai]

    def split_chunk_host(self, host: Dict[str, np.ndarray], d: int,
                         counts: np.ndarray) -> List[Frontier]:
        """Split a chunk whose expansion would overflow capacity.

        ``host`` is the chunk already fetched to host (one batched sync by
        the executor).  Rows are greedily packed, in order, into pieces
        whose total candidate count fits; a single oversized row is split
        by guard *run ranges*, so each piece enumerates a disjoint slice
        of its candidate values.  The pieces equal the reference's
        row-by-row loop; here the rows are gathered with numpy and only
        the greedy packing walks them one by one.
        """
        C = self.capacity
        g_ai, rs, n_rows_g = self.expand_plan(d)
        idx = np.flatnonzero(host["valid"])
        r0 = np.searchsorted(rs, host["lo"][idx, g_ai], side="left")
        r1 = np.searchsorted(rs, host["hi"][idx, g_ai], side="left")
        big = counts[idx] > C
        # oversized rows become ceil(runs / C) rows of at most C runs each
        parts = np.where(big, -(-(r1 - r0) // C), 1)
        src = np.repeat(idx, parts)
        first = np.repeat(np.cumsum(parts) - parts, parts)
        a = np.repeat(r0, parts) + (np.arange(src.size) - first) * C
        b = np.minimum(a + C, np.repeat(r1, parts))
        split = np.repeat(big, parts)
        lo_g = host["lo"][src, g_ai].copy()
        hi_g = host["hi"][src, g_ai].copy()
        if split.any():
            lo_g[split] = rs[a[split]]
            bs = b[split]
            hi_g[split] = np.where(bs < len(rs),
                                   rs[np.minimum(bs, len(rs) - 1)], n_rows_g)
        # candidates per row: the run count of its (possibly cut) range
        cnt = np.where(split, b - a, np.repeat(r1 - r0, parts))
        # greedy pack rows into pieces
        bounds = [0]
        cur_n = cur_count = 0
        for t, c in enumerate(cnt.tolist()):
            if cur_n and (cur_count + c > C or cur_n == C):
                bounds.append(t)
                cur_n = cur_count = 0
            cur_n += 1
            cur_count += c
        if cur_n:
            bounds.append(src.size)
        return [self._pack_rows(host, src[s:e], g_ai, lo_g[s:e], hi_g[s:e])
                for s, e in zip(bounds[:-1], bounds[1:])]

    def _pack_rows(self, host: Dict[str, np.ndarray], rows: np.ndarray,
                   g_ai: int, lo_g: np.ndarray, hi_g: np.ndarray
                   ) -> Frontier:
        """One chunk of host rows ``rows`` (valid, in order) with the guard
        window replaced by ``[lo_g, hi_g)``; the tail is zero and invalid."""
        C, L = self.capacity, rows.size
        out = {}
        for k in Frontier._fields:
            v = host[k]
            arr = np.zeros((C,) + v.shape[1:], dtype=v.dtype)
            arr[:L] = v[rows]
            if k == "lo":
                arr[:L, g_ai] = lo_g
            elif k == "hi":
                arr[:L, g_ai] = hi_g
            out[k] = torch.from_numpy(arr).to(self.device)
        return Frontier(**out)

    # ------------------------------------------------------------------
    def count(self) -> int:
        ex = ScheduleExecutor(self, mode="count")
        self.last_executor = ex  # call_counts() reads its launches
        return ex.count()

    def evaluate(self) -> Iterator[np.ndarray]:
        """Yields (k, n) int32 blocks of result assignments (order
        columns)."""
        ex = ScheduleExecutor(self, mode="evaluate")
        self.last_executor = ex
        yield from ex.evaluate()

    def evaluate_stream(self) -> Iterator[np.ndarray]:
        """Streaming evaluation: the same blocks as :meth:`evaluate`, in
        the same order, with each block's device→host copy issued
        asynchronously as the block is produced (at most
        ``emit_in_flight`` in flight)."""
        ex = ScheduleExecutor(self, mode="evaluate")
        self.last_executor = ex
        yield from ex.evaluate_stream()
