"""Plain PyTorch EXPAND: the contract the fused CUDA kernel (``cuda.py``)
is held to.

The counterpart of the reference's XLA chain
(``repro/kernels/expand/xla.py::expand_step``) with its default bounded
search: the chain EXPAND of ``chain.py`` with ``impl="bsearch"``, the
fixed-trip binary search whose trip count and update the kernel's search
repeats.  Rows past the valid prefix are unconstrained.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import chain

__all__ = ["expand_step"]


def expand_step(F, g_col: torch.Tensor, g_rs: torch.Tensor,
                other_cols: Sequence[torch.Tensor], *, d: int, g_ai: int,
                other_ais: Tuple[int, ...], n_rows_g: int):
    """One frontier expansion: returns ``(F', needed)`` with ``needed``
    the candidate-slot total as a 0-d int32 tensor."""
    return chain.expand_step(F, g_col, g_rs, other_cols, d=d, g_ai=g_ai,
                             other_ais=other_ais, n_rows_g=n_rows_g,
                             impl="bsearch")
