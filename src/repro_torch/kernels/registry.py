"""Kernel registry: the single entry point for the join's device kernels.

Every kernel is reached through this module:

  * **bounded search** (``lower_bound``/``upper_bound``) — the batched
    leapfrog-seek primitive, with ``impl`` choosing between the
    branchless fixed-trip binary search of :func:`_bsearch` (PyTorch ops
    on any device), the leapfrog kernel (``leapfrog/``: ``ctj_bound`` on
    a CUDA column, the dense masked count of ``leapfrog/plain.py`` on a
    CPU column) and the dense count over the whole column at once
    (``"ref"``, for tests); and :func:`bound_atoms`, the membership test
    of one chain EXPAND (every atom's lower and upper bound: under
    ``impl="leapfrog"`` one ``ctj_bound_atoms`` launch on a CUDA chunk,
    else the atom loop of ``leapfrog/plain.bound_atoms`` over ``impl``'s
    bounded search);
  * **EXPAND** (``expand_fn``) — one frontier-expansion step, on one of
    two paths: ``"fused"`` (the EXPAND kernel) or ``"chain"`` (the op
    chain of ``expand/chain.py``, whose bounded searches go through
    :func:`bound_atoms`);
  * **FOLD** (``fold_fn``) — one bracket close in evaluation mode, in
    three arities: replay-only (representative row blocks replayed
    through ``orig``), splice-only (tier-2 payload hits' cached blocks
    spliced from the slab) and merged (both in one chunk, the static
    executor's); on one of two paths, ``"fused"`` (the FOLD kernels) or
    ``"chain"`` (the op chain of ``fold/chain.py``);
  * **EMIT** (``emit_fn``) — the stable valid-row pack of a result chunk,
    ``"fused"`` (the EMIT kernel) or ``"chain"`` (``emit/chain.py``).

On the ``"fused"`` path dispatch goes by the device of the chunk a built
function is called with: a CUDA tensor launches the hand-written CUDA
kernel (``<op>/cuda.py``, sources in ``repro_torch/csrc``), a CPU tensor
runs the plain PyTorch version (``<op>/plain.py``).  The ``"chain"`` path
runs its PyTorch ops on whatever device the chunk is on.  The path
choices are the caller's, as in the reference: each op's path
(:data:`KERNEL_PATHS`, the reference's ``expand_kernel`` /
``fold_kernel`` / ``emit_kernel``) and the chain EXPAND's bounded search
(``impl``).  There is no autotune and no fallback: a CUDA launch that
fails raises, and one path never stands in for the other.  Each path checks its inputs once: the CUDA
wrappers check device, dtype, shape and contiguity of every pointer they
pass, and the built functions here check the plain path's chunks against
the spec.  :func:`path_of` names the path a tensor takes
(``"cuda"`` | ``"torch"``); executors count launches per path with it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import torch

__all__ = ["ExpandSpec", "FoldSpec", "EmitSpec", "BOUND_IMPLS",
           "KERNEL_PATHS", "lower_bound", "upper_bound", "bound_atoms",
           "path_of",
           "expand_fn", "fold_fn", "emit_fn"]

BOUND_IMPLS = ("bsearch", "leapfrog", "ref")
KERNEL_PATHS = ("fused", "chain")


# ---------------------------------------------------------------------------
# Bounded search
# ---------------------------------------------------------------------------


def _bsearch(col: torch.Tensor, values: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor, strict: bool = True) -> torch.Tensor:
    """Vectorized bounded binary search over ``col[lo:hi)``; log2(N)+1
    fixed iterations, so the result is the insertion point (left for
    ``strict``, right otherwise) whenever the window is sorted."""
    n = col.shape[0]
    if n == 0:
        return lo
    trips = max(1, int(math.ceil(math.log2(n + 1))) + 1)
    lo_, hi_ = lo.to(torch.int32), hi.to(torch.int32)
    for _ in range(trips):
        go = lo_ < hi_
        mid = (lo_ + hi_) >> 1
        x = col[mid.clamp(0, n - 1)]
        pred = (x < values) if strict else (x <= values)
        lo2 = torch.where(go & pred, mid + 1, lo_)
        hi_ = torch.where(go & ~pred, mid, hi_)
        lo_ = lo2
    return lo_


def _bound(col, values, lo, hi, strict: bool, impl: str) -> torch.Tensor:
    if impl == "bsearch":
        return _bsearch(col, values, lo, hi, strict=strict)
    from .leapfrog import cuda, plain  # lazy: the kernels import this module
    if impl == "leapfrog":
        if path_of(col) == "cuda":
            return cuda.bound(col, values, lo, hi, strict=strict)
        return plain.bound(col, values, lo, hi, strict=strict)
    if impl == "ref":
        return plain.bound_ref(col, values, lo, hi, strict=strict)
    raise ValueError(f"impl must be one of {BOUND_IMPLS}, got {impl!r}")


def lower_bound(col, values, lo, hi, impl: str = "bsearch"):
    return _bound(col, values, lo, hi, True, impl)


def upper_bound(col, values, lo, hi, impl: str = "bsearch"):
    return _bound(col, values, lo, hi, False, impl)


def bound_atoms(cols: Sequence[torch.Tensor], ais: Sequence[int],
                values: torch.Tensor, ok: torch.Tensor, lo2: torch.Tensor,
                hi2: torch.Tensor, *, impl: str, atoms=None) -> None:
    """The membership test of one chain EXPAND, in place: for each atom
    ``ais[k]`` in order, narrow column ``ais[k]`` of every slot's (C, m)
    windows ``lo2``/``hi2`` to the run of ``values`` in ``cols[k]`` and
    clear ``ok`` where the run is empty.  Under ``impl="leapfrog"`` a CUDA
    chunk launches ``ctj_bound_atoms`` over ``atoms``, the columns'
    ``leapfrog.cuda.Atoms`` that ``expand_fn`` builds once (required
    there); otherwise the atom loop of ``leapfrog/plain.bound_atoms`` runs
    with ``impl``'s bounded search (the dense count on a CPU chunk under
    ``"leapfrog"``).  Kernel and loop agree on ``ok`` on every slot and on
    the windows of every slot whose final ``ok`` is set."""
    from .leapfrog import cuda, plain
    if not cols:
        return  # no membership atom at this depth: every slot stands
    if impl == "leapfrog" and path_of(values) == "cuda":
        if atoms is None:
            raise ValueError("a CUDA chunk's leapfrog membership test needs "
                             "the columns' leapfrog.cuda.Atoms")
        cuda.bound_atoms(atoms, values, ok, lo2, hi2)
        return

    def search(col, v, lo, hi, *, strict):
        return _bound(col, v, lo, hi, strict, impl)

    plain.bound_atoms(cols, ais, values, ok, lo2, hi2, search=search)


# ---------------------------------------------------------------------------
# Specs and dispatch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExpandSpec:
    """The shape of one EXPAND(d) op's chunks; a built step checks every
    chunk it is given against it."""

    capacity: int     # chunk capacity C
    n_vars: int       # assignment columns (order length)
    n_atoms: int      # lo/hi columns (atom count m)
    n_others: int     # participating membership atoms at this depth


@dataclass(frozen=True)
class FoldSpec:
    """The shape of one FOLD_CHILD bracket close."""

    capacity: int
    n_vars: int
    n_atoms: int


@dataclass(frozen=True)
class EmitSpec:
    """The shape of one EMIT pack ``fn(assign, valid) -> (packed, k)``."""

    capacity: int
    n_vars: int


def path_of(t: torch.Tensor) -> str:
    """The kernel path a tensor on this device takes."""
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel path for device {t.device}")


def _check_path(path: str) -> None:
    if path not in KERNEL_PATHS:
        raise ValueError(f"path must be one of {KERNEL_PATHS}, got {path!r}")


def _check(what: str, t: torch.Tensor, shape: Tuple[int, ...],
           dtype: torch.dtype) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{what}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check_chunk(spec, F) -> None:
    C, n, m = spec.capacity, spec.n_vars, spec.n_atoms
    _check("assign", F.assign, (C, n), torch.int32)
    _check("factor", F.factor, (C,), torch.int64)
    _check("valid", F.valid, (C,), torch.bool)
    _check("orig", F.orig, (C,), torch.int32)
    _check("lo", F.lo, (C, m), torch.int32)
    _check("hi", F.hi, (C, m), torch.int32)


def expand_fn(spec: ExpandSpec, *, path: str = "fused",
              impl: str = "bsearch", d: int, g_ai: int,
              other_ais: Tuple[int, ...], g_col: torch.Tensor,
              g_rs: torch.Tensor, other_cols: Sequence[torch.Tensor],
              n_rows_g: int) -> Callable:
    """Build the EXPAND(d) step: ``fn(F) -> (F', needed)``.

    ``path="fused"`` runs the EXPAND kernel (its plain version on a CPU
    chunk; ``impl`` does not enter); ``path="chain"`` runs the op chain
    with bounded searches of flavour ``impl``.  The built function
    carries ``fn.path`` and ``fn.bound_calls``: the leapfrog bound calls
    (``ctj_bound_atoms`` launches on a CUDA chunk) one call of it makes
    under ``impl="leapfrog"``, one per group of at most ``MAX_ATOMS``
    membership atoms, none without an atom or with an empty column (no
    slot survives it); else 0.  Under ``impl="leapfrog"`` the columns on a
    CUDA device are checked and laid out for the kernel here, once."""
    from .expand import chain, cuda, plain  # lazy: they import this module
    from .leapfrog import cuda as leapfrog_cuda
    _check_path(path)
    if impl not in BOUND_IMPLS:
        raise ValueError(f"impl must be one of {BOUND_IMPLS}, got {impl!r}")
    other_ais = tuple(other_ais)
    other_cols = tuple(other_cols)
    if len(other_ais) != spec.n_others or len(other_cols) != spec.n_others:
        raise ValueError("other_ais/other_cols do not match spec.n_others")
    kw = dict(d=d, g_ai=g_ai, other_ais=other_ais, n_rows_g=n_rows_g)

    if path == "chain":
        atoms = None
        if (impl == "leapfrog" and other_cols
                and path_of(other_cols[0]) == "cuda"):
            atoms = leapfrog_cuda.Atoms(other_cols, other_ais)

        def fn(F):
            _check_chunk(spec, F)
            return chain.expand_step(F, g_col, g_rs, other_cols, impl=impl,
                                     atoms=atoms, **kw)

        searched = (impl == "leapfrog"
                    and all(c.shape[0] > 0 for c in other_cols))
        fn.bound_calls = (-(-len(other_cols) // leapfrog_cuda.MAX_ATOMS)
                          if searched else 0)
    else:
        def fn(F):
            if path_of(F.assign) == "cuda":
                return cuda.expand(F, g_col, g_rs, other_cols, **kw)
            _check_chunk(spec, F)
            return plain.expand_step(F, g_col, g_rs, other_cols, **kw)

        fn.bound_calls = 0
    fn.path = path
    return fn


def fold_fn(spec: FoldSpec, *, path: str = "fused", d0: int, d1: int,
            with_replay: bool = True, with_splice: bool = False) -> Callable:
    """Build the FOLD step of bracket ``[d0, d1]`` in one of its arities,
    as the reference's ``_fold_fn(d0, d1, with_replay, with_splice)``:

    * replay-only: ``fn(P, active, rep_of_row, E) -> (cont, stats)`` with
      ``stats`` the int64 ``[needed, 0, min(needed, C)]``;
    * splice-only: ``fn(P, hit, poff, plen, slab) -> (cont, stats)`` with
      ``stats`` the int64 ``[0, n_spliced, min(n_spliced, C)]``;
    * merged: ``fn(P, active, rep_of_row, E, hit, poff, plen, slab) ->
      (cont, stats)``, the replay rows then the splice rows, truncated to
      ``C``, with ``stats`` the int64 ``[needed, n_spliced, min(needed, C)
      + min(n_spliced, C)]`` (the static executor's arity).

    ``path="fused"`` runs the FOLD kernels (their plain version on a CPU
    chunk); the replay and merged CUDA kernels require the exit chunk
    valid-prefix compacted with nondecreasing ``orig`` (the executors
    sort an exit chunk that is not).  ``path="chain"`` runs the op chain
    of ``fold/chain.py`` on the chunk's device, which takes exits in any
    order.  The built function carries ``fn.path``."""
    from .fold import chain, cuda
    _check_path(path)
    C = spec.capacity
    step = chain.build(d0=d0, d1=d1, with_replay=with_replay,
                       with_splice=with_splice)
    # the wrapper's name: it is looked up at each call, so a wrapper
    # replaced on the module (a spy) is the one that runs
    kernel = ("merged" if with_replay and with_splice
              else "replay" if with_replay else "splice")

    def check(P, *rest):
        _check_chunk(spec, P)
        if with_replay:
            active, rep_of_row, E, *rest = rest
            _check_chunk(spec, E)
            _check("active", active, (C,), torch.bool)
            _check("rep_of_row", rep_of_row, (C,), torch.int32)
        if with_splice:
            hit, poff, plen, slab = rest
            _check("hit", hit, (C,), torch.bool)
            _check("poff", poff, (C,), torch.int32)
            _check("plen", plen, (C,), torch.int32)
            _check("slab", slab, (slab.shape[0], d1 - d0 + 1), torch.int32)

    def fn(*args):
        if path == "fused" and path_of(args[0].assign) == "cuda":
            return getattr(cuda, kernel)(*args, d0=d0, d1=d1)
        check(*args)
        return step(*args)   # the chain, which plain.py names

    fn.path = path
    return fn


def emit_fn(spec: EmitSpec, *, path: str = "fused") -> Callable:
    """Build the EMIT pack ``fn(assign, valid) -> (packed, k)``: the
    valid rows stably moved to the front, ``k`` their count (a 0-d int32
    tensor on the chunk's device); rows past ``k`` are unconstrained.
    ``path="fused"`` runs the EMIT kernel (its plain version on a CPU
    chunk), ``path="chain"`` the op chain of ``emit/chain.py`` on the
    chunk's device.  The built function carries ``fn.path``."""
    from .emit import chain, cuda
    _check_path(path)
    C = spec.capacity

    def fn(assign, valid):
        if path == "fused" and path_of(assign) == "cuda":
            return cuda.pack(assign, valid)
        _check("assign", assign, (C, spec.n_vars), torch.int32)
        _check("valid", valid, (C,), torch.bool)
        return chain.pack(assign, valid)   # the chain, which plain.py names

    fn.path = path
    return fn
