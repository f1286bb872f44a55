"""Plain PyTorch EMIT: the contract the CUDA kernel (``cuda.py``) is held
to.

The counterpart of the reference's XLA chain
(``repro/kernels/emit/xla.py::build``): the chain EMIT of ``chain.py``,
``pack(assign, valid) -> (packed, k)`` where ``packed`` keeps the chunk
shape ``(C, n)`` with the valid rows moved to the front in row order and
``k`` is their count (0-d int32).  Rows past ``k`` are unconstrained.
"""
from __future__ import annotations

from .chain import pack

__all__ = ["pack"]
