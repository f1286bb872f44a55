"""The chain EMIT: pack the valid result rows into a dense prefix with a
stable argsort and a gather.

The counterpart of the reference's XLA chain
(``repro/kernels/emit/xla.py``), which the reference runs with
``emit_kernel="xla"``; here ``emit_kernel="chain"``.  Its ops run on the
device of the chunk they are given, the card's included, and it is the
contract the EMIT kernel is held to (``plain.py`` is this chain):
``pack(assign, valid) -> (packed, k)`` where ``packed`` keeps the chunk
shape ``(C, n)`` with the valid rows moved to the front in row order and
``k`` is their count (0-d int32).  Rows past ``k`` are unconstrained.
"""
from __future__ import annotations

import torch

__all__ = ["pack"]


def pack(assign: torch.Tensor, valid: torch.Tensor):
    perm = torch.argsort((~valid).to(torch.uint8), stable=True)
    k = valid.sum(dtype=torch.int32)
    return assign[perm], k
