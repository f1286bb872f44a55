"""CUDA FOLD: the wrappers around ``csrc/fold.cu``'s ``ctj_fold_replay``
(replay-only arity), ``ctj_fold_splice`` (splice-only arity) and
``ctj_fold_merged`` (``[replay | splice]`` in one chunk).

Replaces the three arities of the reference's fused Pallas kernel
(``repro/kernels/fold/fused.py::build``).  The replay and merged kernels
require the exit chunk valid-prefix compacted with nondecreasing ``orig``
(the executors' sorted-exits invariant).  A span ``[d0, d1]`` outside the
chunk's columns makes a launch return CUDA error 1 (invalid value), and
the wrapper raises.  The wrappers check their inputs, allocate outputs
and scratch with ``torch.empty`` (the scratch's layout is
:func:`scratch_layout`), and launch on PyTorch's current stream: one
memset and two kernels, a plan that scans as it goes (decoupled
look-back) and a slots launch; ``stats`` stays on the device.  They
have no plain fallback: a failed launch raises.  ``launches`` counts the
calls that launched the replay kernel, ``splice_launches`` those that
launched the splice kernel and ``merged_launches`` those that launched
the merged kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import cudalib

__all__ = ["replay", "splice", "merged", "launches", "splice_launches",
           "merged_launches", "scratch_layout", "TILE"]

launches = 0
splice_launches = 0
merged_launches = 0
TILE = 1024  # parent rows a tile of the plans (kTile in csrc/common.cuh)


def scratch_layout(C: int, arity: str) -> Dict[str, Tuple[int, int]]:
    """The scratch of one arity's kernels (``"replay"``, ``"splice"`` or
    ``"merged"``), as ``{region: (offset, length)}`` in int32 values, in
    order: the status words of the plan's single-pass scans (one 64-bit
    word a tile of ``TILE`` parent rows, so two values, at even offsets;
    the merged arity scans the replay and the splice counts side by
    side) and the plan's ticket (these regions are cleared by the
    memset), then a source row for each tile of output slots (the
    merged arity's splice tiles count from its first splice row), and
    the plan's arrays: ``plb`` (each parent's first exit) and the offsets
    ``roff`` / ``soff`` (C each).  ``"total"`` is the whole length."""
    if arity not in ("replay", "splice", "merged"):
        raise ValueError(f"unknown FOLD arity {arity!r}")
    tiles = -(-C // TILE)
    rep, spl = arity != "splice", arity != "replay"
    lengths = ([("replay_status", 2 * tiles)] * rep
               + [("splice_status", 2 * tiles)] * spl
               + [("ticket", 1)]
               + [("replay_tile_src", tiles)] * rep
               + [("splice_tile_src", tiles)] * spl
               + [("plb", C), ("roff", C)] * rep + [("soff", C)] * spl)
    out, at = {}, 0
    for name, length in lengths:
        out[name] = (at, length)
        at += length
    out["total"] = (0, at)
    return out


def _scratch(C: int, arity: str, dev) -> torch.Tensor:
    return torch.empty(scratch_layout(C, arity)["total"][1],
                       dtype=torch.int32, device=dev)


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
    scratch = _scratch(C, "replay", dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_fold_replay(
            *args_in, C, n, m, d0, d1,
            *_out_ptrs(o),
            stats.data_ptr(), scratch.data_ptr(), scratch.numel(),
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
    scratch = _scratch(C, "splice", dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_fold_splice(
            *args_in, C, n, m, d0, d1, slab.shape[0],
            *_out_ptrs(o),
            stats.data_ptr(), scratch.data_ptr(), scratch.numel(),
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
    scratch = _scratch(C, "merged", dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_fold_merged(
            *args_in, C, n, m, d0, d1, slab.shape[0], *_out_ptrs(o),
            stats.data_ptr(), scratch.data_ptr(), scratch.numel(),
            cudalib.stream_ptr(P.assign))
    cudalib.check(err, "ctj_fold_merged")
    merged_launches += 1
    return P._replace(**o), stats
