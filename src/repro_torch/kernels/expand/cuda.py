"""CUDA EXPAND: the wrapper around ``csrc/expand.cu::ctj_expand``.

Replaces the reference's fused Pallas kernel
(``repro/kernels/expand/fused.py::build``).  The wrapper checks the
chunk, allocates outputs and scratch with ``torch.empty`` (the scratch's
layout is :func:`scratch_layout`), and launches on PyTorch's current
stream: two memsets and two kernels, each a single pass that scans as
it goes (decoupled look-back); ``needed`` stays on the device.  The
kernel takes at most 16 membership atoms (``kMaxOthers`` in
``csrc/expand.cu``); more make the launch return CUDA error 1 (invalid
value), and the wrapper raises.  It has no plain fallback: a failed
launch raises.  ``launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .. import cudalib

__all__ = ["expand", "launches", "scratch_layout", "TILE"]

launches = 0
TILE = 1024  # rows or slots a tile of both kernels (kTile in csrc/expand.cu)


def scratch_layout(C: int, n: int, m: int) -> Dict[str, Tuple[int, int]]:
    """The kernel's scratch, as ``{region: (offset, length)}`` in int32
    values, in order: the status words of the plan's and the slots'
    single-pass scans (one 64-bit word a tile, so two values, at even
    offsets), the two scans' tickets (these three regions are cleared by
    the kernel's memset), ``tile_src`` (a row for each tile of slots),
    and the plan's ``r0``, ``cnt`` and ``off`` (C each).  ``"total"`` is
    the whole length.  No row is staged, so nothing grows with ``n`` or
    ``m``."""
    del n, m
    tiles = -(-C // TILE)
    lengths = (("plan_status", 2 * tiles), ("slot_status", 2 * tiles),
               ("tickets", 2), ("tile_src", tiles), ("r0", C), ("cnt", C),
               ("off", C))
    out, at = {}, 0
    for name, length in lengths:
        out[name] = (at, length)
        at += length
    out["total"] = (0, at)
    return out


def expand(F, g_col: torch.Tensor, g_rs: torch.Tensor,
           other_cols: Sequence[torch.Tensor], *, d: int, g_ai: int,
           other_ais: Tuple[int, ...], n_rows_g: int):
    """One EXPAND(d) on the card: ``(F', needed)`` as the plain version."""
    global launches
    dev = F.assign.device
    C, n = F.assign.shape
    m = F.lo.shape[1]
    k = len(other_cols)
    if len(other_ais) != k or not 0 <= d < n or not 0 <= g_ai < m or any(
            not 0 <= ai < m for ai in other_ais):
        raise ValueError("EXPAND column or atom index out of range")
    i32 = torch.int32
    P = cudalib.ptr
    args_in = [*cudalib.chunk_ptrs(F, "F", dev, C, n, m).values(),
               P(g_col, "g_col", dev, i32, (-1,)),
               P(g_rs, "g_rs", dev, i32, (-1,))]
    cols = (ctypes.c_void_p * max(k, 1))(
        *[P(c, f"other_cols[{i}]", dev, i32, (-1,))
          for i, c in enumerate(other_cols)])
    lens = (ctypes.c_int * max(k, 1))(*[int(c.shape[0]) for c in other_cols])
    ais = (ctypes.c_int * max(k, 1))(*other_ais)
    o = dict(assign=torch.empty_like(F.assign),
             factor=torch.empty_like(F.factor),
             valid=torch.empty_like(F.valid),
             orig=torch.empty_like(F.orig),
             lo=torch.empty_like(F.lo), hi=torch.empty_like(F.hi))
    needed = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_layout(C, n, m)["total"][1],
                          dtype=torch.int32, device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_expand(
            *args_in, ctypes.cast(cols, ctypes.c_void_p),
            ctypes.cast(lens, ctypes.c_void_p),
            ctypes.cast(ais, ctypes.c_void_p), k,
            C, n, m, d, g_ai, int(g_rs.shape[0]), int(n_rows_g),
            *(o[f].data_ptr() for f in
              ("assign", "factor", "valid", "orig", "lo", "hi")),
            needed.data_ptr(), scratch.data_ptr(), scratch.numel(),
            cudalib.stream_ptr(F.assign))
    cudalib.check(err, "ctj_expand")
    launches += 1
    return F._replace(**o), needed[0]
