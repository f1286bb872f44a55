"""CUDA bounded search: the wrappers around ``csrc/leapfrog.cu``.

Replaces the reference's Pallas kernel
(``repro/kernels/leapfrog/leapfrog.py::_bound_pallas``).  Two entry
points, int32 columns, values and windows only; the wrappers raise on
anything else and launch on PyTorch's current stream.  Neither has a
plain fallback: a failed launch raises.

* :func:`bound` (``ctj_bound``): one bound of M queries, the output
  allocated with ``torch.empty``.  An empty column (or no query) returns
  ``lo`` without a launch.  ``launches`` counts its launches.
* :func:`bound_atoms` (``ctj_bound_atoms``): the chain EXPAND's membership
  test, every atom's lower and upper bound for every live slot, narrowing
  ``ok``, ``lo2`` and ``hi2`` in place; one launch per group of at most
  ``MAX_ATOMS`` columns, whose addresses :class:`Atoms` checks and lays
  out once per EXPAND op.  An empty column clears ``ok`` on every slot,
  as its bounds would (both return ``lo``), and no launch is made: no
  slot can survive it.  ``atoms_launches`` counts its launches.

Both answer as the plain version's dense count (``plain.py``) wherever
the searched window ``col[lo:min(hi, N))`` is sorted; ``bound_atoms``
searches only the slots whose ``ok`` is set, and the chain EXPAND keeps
every such slot's windows sorted.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import cudalib

__all__ = ["MAX_ATOMS", "Atoms", "bound", "bound_atoms", "launches",
           "atoms_launches"]

MAX_ATOMS = 8  # kMaxAtoms of csrc/leapfrog.cu: atoms one launch takes

launches = 0
atoms_launches = 0


class _AtomCol(ctypes.Structure):
    """``AtomCol`` of csrc/leapfrog.cu: a column, its length, its lo/hi
    column."""

    _fields_ = [("col", ctypes.c_void_p), ("n", ctypes.c_int),
                ("ai", ctypes.c_int)]


class Atoms:
    """The membership columns of one chain EXPAND, checked (int32,
    contiguous, one CUDA device) and laid out for ``ctj_bound_atoms`` once:
    ``groups`` holds the columns in atom order, at most ``MAX_ATOMS`` a
    group, and none when a column is empty (``empty``)."""

    def __init__(self, cols: Sequence[torch.Tensor], ais: Sequence[int]):
        cols, ais = tuple(cols), tuple(ais)
        if len(cols) != len(ais):
            raise ValueError(f"{len(cols)} columns for {len(ais)} atoms")
        self.device = cols[0].device if cols else None
        live = [_AtomCol(cudalib.ptr(c, f"atom {ai} column", self.device,
                                     torch.int32, (-1,)), c.shape[0], ai)
                for c, ai in zip(cols, ais) if c.shape[0] > 0]
        self.empty = len(live) < len(cols)
        self.groups = [] if self.empty else [
            (_AtomCol * len(g))(*g) for g in
            (live[k:k + MAX_ATOMS] for k in range(0, len(live), MAX_ATOMS))]
        self._cols = cols  # the columns outlive the addresses held here


def bound(col: torch.Tensor, values: torch.Tensor, lo: torch.Tensor,
          hi: torch.Tensor, *, strict: bool) -> torch.Tensor:
    """Bounded lower (``strict``) or upper bound on the card."""
    global launches
    dev = col.device
    m = values.shape[0]
    i32 = torch.int32
    P = cudalib.ptr
    ptrs = (P(col, "col", dev, i32, (-1,)), P(values, "values", dev, i32, (m,)),
            P(lo, "lo", dev, i32, (m,)), P(hi, "hi", dev, i32, (m,)))
    n = int(col.shape[0])
    if n == 0 or m == 0:
        return lo
    out = torch.empty(m, dtype=i32, device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_bound(*ptrs, n, m, int(strict), out.data_ptr(),
                            cudalib.stream_ptr(col))
    cudalib.check(err, "ctj_bound")
    launches += 1
    return out


def bound_atoms(atoms: Atoms, values: torch.Tensor, ok: torch.Tensor,
                lo2: torch.Tensor, hi2: torch.Tensor) -> None:
    """Narrow every live slot's window of each atom to the run of values
    equal to the slot's value, and clear ``ok`` where a run is empty, on
    the card, in place."""
    global atoms_launches
    dev = values.device
    C, m = values.shape[0], lo2.shape[-1]
    i32 = torch.int32
    P = cudalib.ptr
    ptrs = (P(values, "values", dev, i32, (C,)),
            P(ok, "ok", dev, torch.bool, (C,)),
            P(lo2, "lo2", dev, i32, (C, m)), P(hi2, "hi2", dev, i32, (C, m)))
    if atoms.device not in (None, dev):
        raise ValueError(f"atom columns on {atoms.device}, slots on {dev}")
    if atoms.empty:
        ok.zero_()
        return
    lib = cudalib.load()
    stream = cudalib.stream_ptr(values)
    with torch.cuda.device(dev):
        for g in atoms.groups:
            err = lib.ctj_bound_atoms(ctypes.addressof(g), len(g), *ptrs, C,
                                      m, stream)
            cudalib.check(err, "ctj_bound_atoms")
            atoms_launches += 1
