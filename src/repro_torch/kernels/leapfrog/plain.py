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

:func:`bound_ref` is the port of the reference's oracle
(``repro/kernels/leapfrog/ref.py``): the same count over the whole column
at once, for tests.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_BC", "bound", "bound_ref"]

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


def bound_ref(col: torch.Tensor, values: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, *, strict: bool) -> torch.Tensor:
    pos = torch.arange(col.shape[0], dtype=lo.dtype,
                       device=col.device)[None, :]
    cmp = (col[None, :] < values[:, None]) if strict else (
        col[None, :] <= values[:, None])
    mask = (pos >= lo[:, None]) & (pos < hi[:, None]) & cmp
    return lo + mask.sum(dim=1).to(lo.dtype)
