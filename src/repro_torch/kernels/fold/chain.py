"""The chain FOLD: replay, splice and merge as chains of PyTorch ops.

The counterpart of the reference's XLA chain
(``repro/kernels/fold/xla.py``), which the reference runs with
``fold_kernel="xla"``; here ``fold_kernel="chain"``.  Its ops run on the
device of the chunk they are given, the card's included, and it is the
contract the FOLD kernels are held to (``plain.py`` is this chain).

:func:`build` composes the steps into the registry's FOLD contract, one
of three arities selected by ``with_replay``/``with_splice``:

  * replay-only:  ``fn(P, active, rep_of_row, E) -> (cont, stats)``
  * splice-only:  ``fn(P, hit, poff, plen, slab) -> (cont, stats)``
  * merged:       ``fn(P, active, rep_of_row, E, hit, poff, plen, slab)
                  -> (cont, stats)``

``stats`` is an int64 ``(3,)`` vector ``[needed, n_spl, n_valid]``: the
replay pair total, the splice row total (each 0 when that path is absent
from the arity) and ``min(needed, C) + min(n_spl, C)``, which may exceed
``C`` (the static executor checks all three for overflow).  Outputs are
valid-prefix compacted, replay rows first, then splice rows; rows past
the valid prefix are unconstrained.

The chain sorts the exits itself (a stable argsort by representative),
so an exit chunk may come in any order.  Each step lays its pairs out
over slots ``0 .. min(total, C) - 1`` in order (cumsum offsets and
searchsorted, as the chain EXPAND lays out its candidates), so its output
is valid-prefix compacted as laid out: the reference's closing stable
argsort of ``~valid`` is the identity permutation there and is left out.
"""
from __future__ import annotations

import torch

__all__ = ["replay_step", "splice_step", "merge_compact", "stats", "build"]


def _layout(pcnt: torch.Tensor):
    """Slots ``0 .. C-1`` laid out over parents with ``pcnt`` pairs each:
    ``(needed, src, delta, ok)``, ``src`` the parent of each slot and
    ``delta`` the slot's rank among its parent's pairs."""
    C = pcnt.shape[0]
    i32 = torch.int32
    offsets = torch.cumsum(pcnt, 0, dtype=i32) - pcnt         # exclusive
    needed = offsets[-1] + pcnt[-1]
    slot = torch.arange(C, dtype=i32, device=pcnt.device)
    src = (torch.searchsorted(offsets, slot, right=True, out_int32=True)
           - 1).clamp(0, C - 1)
    delta = slot - offsets[src]
    ok = (slot < needed) & (delta < pcnt[src])
    return needed, src, delta, ok


def replay_step(P, active: torch.Tensor, rep_of_row: torch.Tensor, E, *,
                d0: int, d1: int):
    """Scatter one subtree exit chunk back through ``orig``: returns
    ``(cont, needed)``, ``needed`` the pair total as a 0-d int32 tensor.

    For every active parent row *i* (representative ``rep_of_row[i]``)
    and every valid exit row *e* with ``E.orig == rep_of_row[i]``, one
    output row: the parent's assignment with the subtree columns
    ``[d0, d1]`` replaced by the exit row's, and ``factor`` = parent ×
    exit.  Parents in row order, each parent's exits in exit-row order.
    The caller guarantees the pair total fits the chunk capacity (or
    checks ``needed`` for overflow)."""
    C = P.assign.shape[0]
    i32 = torch.int32
    eorig = E.orig.clamp(0, C - 1)
    # exits per representative, and exit rows sorted by representative id
    ecnt = torch.zeros(C, dtype=i32, device=P.assign.device).scatter_add_(
        0, eorig.long(), E.valid.to(i32))
    ekey = torch.where(E.valid, eorig, C)
    eorder = torch.argsort(ekey, stable=True)
    estart = torch.cumsum(ecnt, 0, dtype=i32) - ecnt
    rep = rep_of_row.clamp(0, C - 1)
    pcnt = torch.where(active, ecnt[rep], 0).to(i32)
    needed, src, delta, ok = _layout(pcnt)
    eidx = eorder[(estart[rep[src]] + delta).clamp(0, C - 1)]
    cols = torch.arange(P.assign.shape[1], device=P.assign.device)
    insub = (cols >= d0) & (cols <= d1)
    assign = torch.where(insub[None, :], E.assign[eidx], P.assign[src])
    out = P._replace(assign=assign, factor=P.factor[src] * E.factor[eidx],
                     valid=ok, orig=P.orig[src], lo=P.lo[src], hi=P.hi[src])
    return out, needed


def splice_step(P, mask: torch.Tensor, poff: torch.Tensor,
                plen: torch.Tensor, slab: torch.Tensor, *, d0: int,
                d1: int):
    """:func:`replay_step` with the exit chunk replaced by slab-resident
    blocks: every masked parent row *i* contributes ``plen[i]`` rows, the
    parent's assignment with columns ``[d0, d1]`` taken from slab rows
    ``poff[i] .. poff[i] + plen[i] - 1``; ``factor``, ``orig``, ``lo``
    and ``hi`` are the parent's.  Slab rows are clipped to ``[0, R - 1]``:
    the last row, ``R``, is the store's scratch row and is never read."""
    R = slab.shape[0] - 1
    _, src, delta, ok = _layout(torch.where(mask, plen, 0).to(torch.int32))
    sidx = torch.where(ok, (poff[src] + delta).clamp(0, R - 1), R)
    assign = P.assign[src].clone()
    assign[:, d0:d1 + 1] = slab[sidx]
    return P._replace(assign=assign, factor=P.factor[src], valid=ok,
                      orig=P.orig[src], lo=P.lo[src], hi=P.hi[src])


def merge_compact(A, B):
    """Chunk B's valid prefix appended after chunk A's (both valid-prefix
    compacted), truncated to the capacity: returns the merged chunk and
    the total valid count (0-d int64), which the caller checks for
    overflow."""
    C = A.valid.shape[0]
    n1 = A.valid.sum(dtype=torch.int64)
    n2 = B.valid.sum(dtype=torch.int64)
    slot = torch.arange(C, device=A.valid.device)
    from_b = slot >= n1
    bidx = (slot - n1).clamp(0, C - 1)

    def pick(a, b):
        m = from_b.reshape((C,) + (1,) * (a.dim() - 1))
        return torch.where(m, b[bidx], a)

    out = type(A)(*(pick(a, b) for a, b in zip(A, B)))
    return out._replace(valid=slot < (n1 + n2).clamp(max=C)), n1 + n2


def stats(C: int, needed, n_spl) -> torch.Tensor:
    """The int64 ``[needed, n_spl, min(needed, C) + min(n_spl, C)]``;
    ``needed`` and ``n_spl`` are 0-d tensors, or 0 for an absent path."""
    dev = (needed if torch.is_tensor(needed) else n_spl).device
    needed, n_spl = (torch.as_tensor(x, device=dev).to(torch.int64)
                     .reshape(()) for x in (needed, n_spl))
    return torch.stack([needed, n_spl,
                        needed.clamp(max=C) + n_spl.clamp(max=C)])


def _n_spliced(hit: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    return torch.where(hit, plen, 0).sum(dtype=torch.int64)


def build(*, d0: int, d1: int, with_replay: bool, with_splice: bool):
    """The FOLD step of bracket ``[d0, d1]`` in the arity the flags select
    (module docstring)."""
    if not (with_replay or with_splice):
        raise ValueError("FOLD needs at least one of replay/splice")

    if with_replay and with_splice:
        def fn(P, active, rep_of_row, E, hit, poff, plen, slab):
            C = P.valid.shape[0]
            cont, needed = replay_step(P, active, rep_of_row, E,
                                       d0=d0, d1=d1)
            # the hit parents' blocks go after the replay rows: the
            # fused kernel's [replay | splice] layout
            spl = splice_step(P, hit, poff, plen, slab, d0=d0, d1=d1)
            merged, _ = merge_compact(cont, spl)
            return merged, stats(C, needed, _n_spliced(hit, plen))

        return fn

    if with_replay:
        def fn(P, active, rep_of_row, E):
            cont, needed = replay_step(P, active, rep_of_row, E,
                                       d0=d0, d1=d1)
            return cont, stats(P.valid.shape[0], needed, 0)

        return fn

    def fn(P, hit, poff, plen, slab):
        spl = splice_step(P, hit, poff, plen, slab, d0=d0, d1=d1)
        return spl, stats(P.valid.shape[0], 0, _n_spliced(hit, plen))

    return fn
