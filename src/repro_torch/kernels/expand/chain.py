"""The chain EXPAND: one frontier expansion as a chain of PyTorch ops.

The counterpart of the reference's XLA chain
(``repro/kernels/expand/xla.py::expand_step``), which the reference runs
with ``expand_kernel="xla"``; here ``expand_kernel="chain"``.  It is the
contract the fused CUDA kernel is held to (``plain.expand_step`` is this
chain with ``impl="bsearch"``):

* enumerate each valid row's guard candidate runs (searchsorted over the
  run-start array), lay the (row, candidate) pairs out over output slots
  via cumsum + searchsorted;
* verify each candidate's membership in every other participating atom
  with bounded search (a lower and an upper bound per atom), narrowing
  that atom's [lo, hi) trie window, through ``registry.bound_atoms``:
  under ``impl="leapfrog"`` on a CUDA chunk one kernel launch for all
  atoms, which searches only the slots still alive; otherwise atom by
  atom with the given ``impl``;
* compact surviving rows to the front of the chunk (stable partition).

The searchsorted, cumsum, gathers and stable argsort are PyTorch ops on
the chunk's device, as the reference leaves them to XLA; only the bounded
search has a kernel of its own (``impl="leapfrog"``: ``ctj_bound_atoms``
on a CUDA chunk, one launch per EXPAND).  Every window a live slot (below
``needed``, a candidate of its row) searches is sorted (a trie level's
column is sorted within each parent run and a window never crosses a
run); other slots may hold stale windows, and ``ok`` masks them out.
Generic over any Frontier-shaped NamedTuple
(assign/factor/valid/orig/lo/hi).  Rows past the valid prefix are
unconstrained.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..registry import bound_atoms

__all__ = ["expand_step", "compact"]


def compact(F):
    """Stable-partition valid rows to the front of the chunk."""
    perm = torch.argsort((~F.valid).to(torch.uint8), stable=True)
    return type(F)(*(x[perm] for x in F))


def expand_step(F, g_col: torch.Tensor, g_rs: torch.Tensor,
                other_cols: Sequence[torch.Tensor], *, d: int, g_ai: int,
                other_ais: Tuple[int, ...], n_rows_g: int, impl: str,
                atoms=None):
    """One frontier expansion: returns ``(F', needed)`` with ``needed``
    the candidate-slot total as a 0-d int32 tensor.  ``atoms``: the
    membership columns laid out for the leapfrog kernel
    (``leapfrog.cuda.Atoms``), required under ``impl="leapfrog"`` on a
    CUDA chunk."""
    C = F.assign.shape[0]
    dev = F.assign.device
    i32 = torch.int32
    nruns = g_rs.shape[0]
    r0 = torch.searchsorted(g_rs, F.lo[:, g_ai].contiguous(), out_int32=True)
    r1 = torch.searchsorted(g_rs, F.hi[:, g_ai].contiguous(), out_int32=True)
    counts = torch.where(F.valid, r1 - r0, 0).to(i32)
    offsets = torch.cumsum(counts, 0, dtype=i32) - counts     # exclusive
    needed = offsets[-1] + counts[-1]
    slot = torch.arange(C, dtype=i32, device=dev)
    src = torch.searchsorted(offsets, slot, right=True, out_int32=True) - 1
    src = src.clamp(0, C - 1)
    delta = slot - offsets[src]
    ok = (slot < needed) & (delta < counts[src])
    if nruns:
        k = (r0[src] + delta).clamp(0, nruns - 1)
        pos = g_rs[k]
        value = g_col[pos.clamp(0, max(n_rows_g - 1, 0))]
        run_end = torch.where(k + 1 < nruns,
                              g_rs[(k + 1).clamp(0, nruns - 1)],
                              n_rows_g).to(i32)
    else:
        pos = value = run_end = torch.zeros_like(slot)
        ok = torch.zeros_like(ok)
    lo2, hi2 = F.lo[src], F.hi[src]   # gathers: new tensors
    lo2[:, g_ai] = pos
    hi2[:, g_ai] = run_end
    bound_atoms(other_cols, other_ais, value, ok, lo2, hi2, impl=impl,
                atoms=atoms)
    assign2 = F.assign[src].clone()
    assign2[:, d] = value
    out = F._replace(assign=assign2, factor=F.factor[src], valid=ok,
                     orig=F.orig[src], lo=lo2, hi=hi2)
    return compact(out), needed
