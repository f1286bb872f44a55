"""CUDA FOLD: the wrappers around ``csrc/fold.cu``'s ``ctj_fold_replay``
(replay-only arity), ``ctj_fold_splice`` (splice-only arity) and
``ctj_fold_merged`` (``[replay | splice]`` in one chunk).

Replaces the three arities of the reference's fused Pallas kernel
(``repro/kernels/fold/fused.py::build``).  The replay and merged kernels
require the exit chunk valid-prefix compacted with nondecreasing ``orig``
(the executors' sorted-exits invariant).  A span ``[d0, d1]`` outside the
chunk's columns makes a launch return CUDA error 1 (invalid value), and
the wrapper raises.  The wrappers check their inputs, allocate outputs
and scratch with ``torch.empty``, and launch on PyTorch's current
stream; ``stats`` stays on the device.  They have no plain
fallback: a failed launch raises.  ``launches`` counts the calls that
launched the replay kernel, ``splice_launches`` those that launched the
splice kernel and ``merged_launches`` those that launched the merged
kernel.
"""
from __future__ import annotations

import torch

from .. import cudalib

__all__ = ["replay", "splice", "merged", "launches", "splice_launches",
           "merged_launches"]

launches = 0
splice_launches = 0
merged_launches = 0


def _outputs(P):
    return dict(assign=torch.empty_like(P.assign),
                factor=torch.empty_like(P.factor),
                valid=torch.empty_like(P.valid),
                orig=torch.empty_like(P.orig),
                lo=torch.empty_like(P.lo), hi=torch.empty_like(P.hi))


def _out_ptrs(o):
    return [o[f].data_ptr() for f in
            ("assign", "factor", "valid", "orig", "lo", "hi")]


def replay(P, active: torch.Tensor, rep_of_row: torch.Tensor, E, *,
           d0: int, d1: int):
    """One replay-only FOLD on the card: ``(cont, stats)`` as the plain
    version."""
    global launches
    dev = P.assign.device
    C, n = P.assign.shape
    m = P.lo.shape[1]
    pp = cudalib.chunk_ptrs(P, "P", dev, C, n, m)
    ep = cudalib.chunk_ptrs(E, "E", dev, C, n, m)
    args_in = [pp["assign"], pp["factor"], pp["orig"], pp["lo"], pp["hi"],
               cudalib.ptr(active, "active", dev, torch.bool, (C,)),
               cudalib.ptr(rep_of_row, "rep_of_row", dev, torch.int32, (C,)),
               ep["assign"], ep["factor"], ep["valid"], ep["orig"]]
    o = _outputs(P)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    scratch = torch.empty(3 * C + 1, dtype=torch.int32, device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_fold_replay(
            *args_in, C, n, m, d0, d1,
            *_out_ptrs(o),
            stats.data_ptr(), scratch.data_ptr(),
            cudalib.stream_ptr(P.assign))
    cudalib.check(err, "ctj_fold_replay")
    launches += 1
    return P._replace(**o), stats


def splice(P, hit: torch.Tensor, poff: torch.Tensor, plen: torch.Tensor,
           slab: torch.Tensor, *, d0: int, d1: int):
    """One splice-only FOLD on the card: ``(cont, stats)`` as the plain
    version."""
    global splice_launches
    dev = P.assign.device
    C, n = P.assign.shape
    m = P.lo.shape[1]
    pp = cudalib.chunk_ptrs(P, "P", dev, C, n, m)
    args_in = [pp["assign"], pp["factor"], pp["orig"], pp["lo"], pp["hi"],
               cudalib.ptr(hit, "hit", dev, torch.bool, (C,)),
               cudalib.ptr(poff, "poff", dev, torch.int32, (C,)),
               cudalib.ptr(plen, "plen", dev, torch.int32, (C,)),
               cudalib.ptr(slab, "slab", dev, torch.int32,
                           (-1, d1 - d0 + 1))]
    o = _outputs(P)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    scratch = torch.empty(2 * C + 1, dtype=torch.int32, device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_fold_splice(
            *args_in, C, n, m, d0, d1, slab.shape[0],
            *_out_ptrs(o),
            stats.data_ptr(), scratch.data_ptr(),
            cudalib.stream_ptr(P.assign))
    cudalib.check(err, "ctj_fold_splice")
    splice_launches += 1
    return P._replace(**o), stats


def merged(P, active: torch.Tensor, rep_of_row: torch.Tensor, E,
           hit: torch.Tensor, poff: torch.Tensor, plen: torch.Tensor,
           slab: torch.Tensor, *, d0: int, d1: int):
    """One merged FOLD on the card: ``(cont, stats)`` as the plain
    version."""
    global merged_launches
    dev = P.assign.device
    C, n = P.assign.shape
    m = P.lo.shape[1]
    pp = cudalib.chunk_ptrs(P, "P", dev, C, n, m)
    ep = cudalib.chunk_ptrs(E, "E", dev, C, n, m)
    args_in = [pp["assign"], pp["factor"], pp["orig"], pp["lo"], pp["hi"],
               cudalib.ptr(active, "active", dev, torch.bool, (C,)),
               cudalib.ptr(rep_of_row, "rep_of_row", dev, torch.int32, (C,)),
               ep["assign"], ep["factor"], ep["valid"], ep["orig"],
               cudalib.ptr(hit, "hit", dev, torch.bool, (C,)),
               cudalib.ptr(poff, "poff", dev, torch.int32, (C,)),
               cudalib.ptr(plen, "plen", dev, torch.int32, (C,)),
               cudalib.ptr(slab, "slab", dev, torch.int32,
                           (-1, d1 - d0 + 1))]
    o = _outputs(P)
    stats = torch.empty(3, dtype=torch.int64, device=dev)
    scratch = torch.empty(5 * C + 2, dtype=torch.int32, device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_fold_merged(
            *args_in, C, n, m, d0, d1, slab.shape[0], *_out_ptrs(o),
            stats.data_ptr(), scratch.data_ptr(),
            cudalib.stream_ptr(P.assign))
    cudalib.check(err, "ctj_fold_merged")
    merged_launches += 1
    return P._replace(**o), stats
