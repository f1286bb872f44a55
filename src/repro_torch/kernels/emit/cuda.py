"""CUDA EMIT: the wrapper around ``csrc/emit.cu::ctj_emit``.

Replaces the reference's fused Pallas kernel
(``repro/kernels/emit/fused.py::build``).  The wrapper checks its
inputs, allocates the output and scratch with ``torch.empty``, and
launches on PyTorch's current stream; ``k`` stays on the device.  It has
no plain fallback: a failed launch raises.  ``launches`` counts the
calls that launched the kernel.
"""
from __future__ import annotations

import torch

from .. import cudalib

__all__ = ["pack", "launches"]

launches = 0


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
    csum = torch.empty(C, dtype=torch.int32, device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_emit(a_ptr, v_ptr, C, n, packed.data_ptr(),
                           k.data_ptr(), csum.data_ptr(),
                           cudalib.stream_ptr(assign))
    cudalib.check(err, "ctj_emit")
    launches += 1
    return packed, k[0]
