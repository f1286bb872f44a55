"""Plain PyTorch FOLD in its three arities: replay-only, splice-only and
merged — the contract the CUDA kernels (``cuda.py``) are held to.

The counterpart of the reference's XLA chain
(``repro/kernels/fold/xla.py``): the chain FOLD of ``chain.py``, whose
steps and layout this module's entry points name.

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

from . import chain

__all__ = ["replay", "splice", "merged"]


def replay(P, active: torch.Tensor, rep_of_row: torch.Tensor, E, *,
           d0: int, d1: int):
    """Replay one exit chunk through ``orig``: returns ``(cont, stats)``
    with ``stats`` the int64 ``[needed, 0, min(needed, C)]``.  The caller
    guarantees the pair total fits the chunk capacity."""
    return chain.build(d0=d0, d1=d1, with_replay=True, with_splice=False)(
        P, active, rep_of_row, E)


def splice(P, hit: torch.Tensor, poff: torch.Tensor, plen: torch.Tensor,
           slab: torch.Tensor, *, d0: int, d1: int):
    """Splice the hit parents' slab blocks: returns ``(cont, stats)`` with
    ``stats`` the int64 ``[0, n_spliced, min(n_spliced, C)]``,
    ``n_spliced`` uncapped."""
    return chain.build(d0=d0, d1=d1, with_replay=False, with_splice=True)(
        P, hit, poff, plen, slab)


def merged(P, active: torch.Tensor, rep_of_row: torch.Tensor, E,
           hit: torch.Tensor, poff: torch.Tensor, plen: torch.Tensor,
           slab: torch.Tensor, *, d0: int, d1: int):
    """Replay the misses and splice the hits into one chunk, replay rows
    first: returns ``(cont, stats)``."""
    return chain.build(d0=d0, d1=d1, with_replay=True, with_splice=True)(
        P, active, rep_of_row, E, hit, poff, plen, slab)
