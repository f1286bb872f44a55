"""CUDA EMIT: the wrapper around ``csrc/emit.cu::ctj_emit``.

Replaces the reference's fused Pallas kernel
(``repro/kernels/emit/fused.py::build``).  The wrapper checks its
inputs, allocates the output and scratch with ``torch.empty`` (the
scratch's layout is :func:`scratch_layout`), and launches on PyTorch's
current stream: one memset and one kernel, a single pass that scans as
it goes (decoupled look-back); ``k`` stays on the device.  It has no
plain fallback: a failed launch raises.  ``launches`` counts the calls
that launched the kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import cudalib

__all__ = ["pack", "launches", "scratch_layout", "TILE"]

launches = 0
TILE = 1024  # rows a tile of the kernel (kTile in csrc/common.cuh)


def scratch_layout(C: int) -> Dict[str, Tuple[int, int]]:
    """The kernel's scratch, as ``{region: (offset, length)}`` in int32
    values: the status words of its single-pass scan (one 64-bit word a
    tile of ``TILE`` rows, so two values, from offset 0) and its ticket,
    both cleared by the kernel's memset.  ``"total"`` is the whole
    length."""
    tiles = -(-C // TILE)
    return {"status": (0, 2 * tiles), "ticket": (2 * tiles, 1),
            "total": (0, 2 * tiles + 1)}


def pack(assign: torch.Tensor, valid: torch.Tensor):
    """Stable valid-row pack on the card: ``(packed, k)`` as the plain
    version."""
    global launches
    dev = assign.device
    C, n = assign.shape
    a_ptr = cudalib.ptr(assign, "assign", dev, torch.int32, (C, n))
    v_ptr = cudalib.ptr(valid, "valid", dev, torch.bool, (C,))
    packed = torch.empty_like(assign)
    k = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_layout(C)["total"][1], dtype=torch.int32,
                          device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_emit(a_ptr, v_ptr, C, n, packed.data_ptr(),
                           k.data_ptr(), scratch.data_ptr(), scratch.numel(),
                           cudalib.stream_ptr(assign))
    cudalib.check(err, "ctj_emit")
    launches += 1
    return packed, k[0]
