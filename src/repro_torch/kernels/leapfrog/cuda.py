"""CUDA bounded search: the wrapper around ``csrc/leapfrog.cu::ctj_bound``.

Replaces the reference's Pallas kernel
(``repro/kernels/leapfrog/leapfrog.py::_bound_pallas``).  The kernel
takes int32 columns, values and windows only; the wrapper raises on
anything else, allocates the output with ``torch.empty`` and launches on
PyTorch's current stream.  The kernel's answer equals the plain version's
dense count on every query whose window ``col[lo:min(hi, N))`` is sorted
(the only windows the chain EXPAND relies on).  An empty column (or no
query) returns ``lo`` without a launch.  It has no plain fallback: a failed launch
raises.  ``launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import torch

from .. import cudalib

__all__ = ["bound", "launches"]

launches = 0


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
