"""Plain PyTorch bounded search: the dense masked count of the TPU kernel.

The counterpart of the reference's Pallas kernel
(``repro/kernels/leapfrog/leapfrog.py::_bound_pallas``) and the contract
the CUDA kernel (``cuda.py``) is held to.  For each query ``(v, lo, hi)``

    bound = lo + |{p in [lo, hi) and [0, N) : col[p] < v}|

(``<=`` for the upper bound), with ``v`` cast to the column's dtype and
the result in ``lo``'s dtype; ``lo`` comes back unchanged when the column
is empty.  The count runs over column blocks of ``DEFAULT_BC`` values, so
its memory stays O(M x DEFAULT_BC) for M queries.  On a window that is
sorted the count is the insertion point, as a binary search finds it.

:func:`bound_atoms` is the chain EXPAND's membership test built on it,
the contract ``ctj_bound_atoms`` is held to: for each membership atom in
turn, the lower bound of every slot's value in its window, the upper
bound from there, ``ok`` cleared where the two meet, both written back
into the window, in place.  The CUDA kernel must give the same ``ok`` on
every slot and the same windows on every slot whose final ``ok`` is set
(it searches no slot whose ``ok`` is clear and writes the windows of no
slot that an atom rejects).

:func:`bound_ref` is the port of the reference's oracle
(``repro/kernels/leapfrog/ref.py``): the same count over the whole column
at once, for tests.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["DEFAULT_BC", "bound", "bound_atoms", "bound_ref"]

DEFAULT_BC = 1024  # column values per block, as the reference's kernel


def bound(col: torch.Tensor, values: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor, *, strict: bool,
          block_c: int = DEFAULT_BC) -> torch.Tensor:
    n = col.shape[0]
    if n == 0:
        return lo
    v = values.to(col.dtype)[:, None]
    lo32, hi32 = lo.to(torch.int32), hi.to(torch.int32)
    count = torch.zeros(values.shape[0], dtype=torch.int32,
                        device=col.device)
    for j in range(0, n, block_c):
        blk = col[j:j + block_c][None, :]
        pos = torch.arange(j, j + blk.shape[1], dtype=torch.int32,
                           device=col.device)[None, :]
        cmp = (blk < v) if strict else (blk <= v)
        mask = cmp & (pos >= lo32[:, None]) & (pos < hi32[:, None])
        count += mask.sum(dim=1, dtype=torch.int32)
    return lo32.to(lo.dtype) + count.to(lo.dtype)


def bound_atoms(cols: Sequence[torch.Tensor], ais: Sequence[int],
                values: torch.Tensor, ok: torch.Tensor, lo2: torch.Tensor,
                hi2: torch.Tensor, *, search: Callable = bound) -> None:
    """Narrow column ``ai`` of the (C, m) windows ``lo2``/``hi2`` of every
    slot to the run of ``values`` in ``cols[k]``, for each ``(k, ai)`` in
    order, and clear ``ok`` where a run is empty; in place.  An empty
    column gives empty runs.  ``search(col, values, lo, hi, strict=...)``
    finds each bound: the dense count by default; the chain EXPAND passes
    its ``impl``'s bounded search (``registry.bound_atoms``)."""
    for col, ai in zip(cols, ais):
        hi = hi2[:, ai]
        s = search(col, values, lo2[:, ai], hi, strict=True)
        e = search(col, values, s, hi, strict=False)
        ok &= s < e
        lo2[:, ai] = s
        hi2[:, ai] = e


def bound_ref(col: torch.Tensor, values: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, *, strict: bool) -> torch.Tensor:
    pos = torch.arange(col.shape[0], dtype=lo.dtype,
                       device=col.device)[None, :]
    cmp = (col[None, :] < values[:, None]) if strict else (
        col[None, :] <= values[:, None])
    mask = (pos >= lo[:, None]) & (pos < hi[:, None]) & cmp
    return lo + mask.sum(dim=1).to(lo.dtype)
