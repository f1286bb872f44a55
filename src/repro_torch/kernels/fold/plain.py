"""Plain PyTorch FOLD in its three arities: replay-only, splice-only and
merged.

The counterpart of the reference's XLA chain
(``repro/kernels/fold/xla.py::replay_step``, ``splice_step``,
``merge_compact`` and ``_stats``) and the contract the CUDA kernels
(``cuda.py``) are held to.

**Replay** (:func:`replay`).  For every active
parent row *i* (representative ``rep_of_row[i]``) and every valid exit
row *e* with ``E.orig == rep_of_row[i]``, one output row: the parent's
assignment with the subtree columns ``[d0, d1]`` replaced by the exit
row's, and ``factor`` = parent × exit.  Parents in row order, each
parent's exits in exit-row order; rows past the valid prefix are
unconstrained.

**Splice** (:func:`splice`).  Every parent row *i* with a tier-2 payload
hit contributes ``plen[i]`` rows: the parent's assignment with columns
``[d0, d1]`` taken from its cached block, slab rows ``poff[i] ..
poff[i] + plen[i] - 1``; ``factor``, ``orig``, ``lo`` and ``hi`` are the
parent's.  Parents in row order; the offsets partition the output, so the
valid rows are a prefix without a compaction.

**Merged** (:func:`merged`).  Both in one chunk, ``[replay | splice]``:
the replay rows first, truncated to ``n1 = min(needed, C)``, then the
splice rows in slots ``n1 .. min(n1 + n_spliced, C) - 1``.  ``stats`` is
``[needed, n_spliced, min(needed, C) + min(n_spliced, C)]``; the third
figure may exceed ``C`` (the static executor checks it for overflow).
"""
from __future__ import annotations

import torch

from ..expand.chain import compact

__all__ = ["replay", "splice", "merged", "stats"]


def stats(C: int, needed: torch.Tensor) -> torch.Tensor:
    """The int64 ``[needed, n_spliced, min(needed, C)]`` triple of the
    replay-only arity (nothing is spliced)."""
    needed = needed.to(torch.int64).reshape(())
    return torch.stack([needed, torch.zeros_like(needed),
                        needed.clamp(max=C)])


def replay(P, active: torch.Tensor, rep_of_row: torch.Tensor, E, *,
           d0: int, d1: int):
    """Replay one exit chunk through ``orig``: returns ``(cont, stats)``.
    The caller guarantees the pair total fits the chunk capacity."""
    C = P.assign.shape[0]
    dev = P.assign.device
    i32 = torch.int32
    eorig = E.orig.clamp(0, C - 1)
    # exits per representative, and exit rows sorted by representative id
    ecnt = torch.zeros(C, dtype=i32, device=dev).scatter_add_(
        0, eorig.long(), E.valid.to(i32))
    ekey = torch.where(E.valid, eorig, C)
    eorder = torch.argsort(ekey, stable=True)
    estart = torch.cumsum(ecnt, 0, dtype=i32) - ecnt
    # enumerate (parent, exit) pairs: cumsum offsets + searchsorted
    rep = rep_of_row.clamp(0, C - 1)
    pcnt = torch.where(active, ecnt[rep], 0).to(i32)
    offsets = torch.cumsum(pcnt, 0, dtype=i32) - pcnt
    needed = offsets[-1] + pcnt[-1]
    slot = torch.arange(C, dtype=i32, device=dev)
    src = (torch.searchsorted(offsets, slot, right=True, out_int32=True)
           - 1).clamp(0, C - 1)
    delta = slot - offsets[src]
    ok = (slot < needed) & (delta < pcnt[src])
    eidx = eorder[(estart[rep[src]] + delta).clamp(0, C - 1)]
    cols = torch.arange(P.assign.shape[1], device=dev)
    insub = (cols >= d0) & (cols <= d1)
    assign = torch.where(insub[None, :], E.assign[eidx], P.assign[src])
    out = P._replace(assign=assign, factor=P.factor[src] * E.factor[eidx],
                     valid=ok, orig=P.orig[src], lo=P.lo[src], hi=P.hi[src])
    return compact(out), stats(C, needed)


def splice(P, hit: torch.Tensor, poff: torch.Tensor, plen: torch.Tensor,
           slab: torch.Tensor, *, d0: int, d1: int):
    """Splice the hit parents' slab blocks: returns ``(cont, stats)`` with
    ``stats`` the int64 ``[0, n_spliced, min(n_spliced, C)]``,
    ``n_spliced`` uncapped.  Slab rows are clipped to ``[0, R - 1]``: the
    last row, ``R``, is the store's scratch row and is never read."""
    C = P.assign.shape[0]
    dev = P.assign.device
    i32 = torch.int32
    R = slab.shape[0] - 1
    pcnt = torch.where(hit, plen, 0).to(i32)
    offsets = torch.cumsum(pcnt, 0, dtype=i32) - pcnt
    n_spl = torch.where(hit, plen, 0).sum(dtype=torch.int64)
    slot = torch.arange(C, dtype=i32, device=dev)
    src = (torch.searchsorted(offsets, slot, right=True, out_int32=True)
           - 1).clamp(0, C - 1)
    delta = slot - offsets[src]
    ok = (slot < n_spl) & (delta < pcnt[src])
    sidx = torch.where(ok, (poff[src] + delta).clamp(0, R - 1), R)
    assign = P.assign[src].clone()
    assign[:, d0:d1 + 1] = slab[sidx]
    out = P._replace(assign=assign, factor=P.factor[src], valid=ok,
                     orig=P.orig[src], lo=P.lo[src], hi=P.hi[src])
    return out, torch.stack([torch.zeros_like(n_spl), n_spl,
                             n_spl.clamp(max=C)])


def merged(P, active: torch.Tensor, rep_of_row: torch.Tensor, E,
           hit: torch.Tensor, poff: torch.Tensor, plen: torch.Tensor,
           slab: torch.Tensor, *, d0: int, d1: int):
    """Replay the misses and splice the hits into one chunk, replay rows
    first (the reference's ``merge_compact`` of the two): returns
    ``(cont, stats)``."""
    C = P.assign.shape[0]
    cont, rstats = replay(P, active, rep_of_row, E, d0=d0, d1=d1)
    spl, sstats = splice(P, hit, poff, plen, slab, d0=d0, d1=d1)
    n1, n2 = rstats[2], sstats[2]
    slot = torch.arange(C, device=P.assign.device)
    from_spl = slot >= n1
    sidx = (slot - n1).clamp(0, C - 1)

    def pick(a, b):
        m = from_spl.reshape((C,) + (1,) * (a.dim() - 1))
        return torch.where(m, b[sidx], a)

    out = type(P)(*(pick(a, b) for a, b in zip(cont, spl)))
    out = out._replace(valid=slot < (n1 + n2).clamp(max=C))
    return out, torch.stack([rstats[0], sstats[1], n1 + n2])
