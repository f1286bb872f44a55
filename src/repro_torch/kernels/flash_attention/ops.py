"""Attention dispatch: the one entry point the model's attention calls.

The counterpart of the reference's ``repro/kernels/flash_attention/ops.py``,
with its ``impl`` mirrored (``convert.ATTENTION_IMPLS`` maps the
reference's names):

  * ``"fused"`` (the reference's ``"pallas"``, and the port's default):
    the hand-written CUDA kernel (``cuda.py``) on a CUDA tensor, the
    plain blocked online softmax (``plain.py``) on a CPU tensor;
  * ``"chain"`` (the reference's ``"xla"``): the plain blocked online
    softmax on any device;
  * ``"ref"``: the dense oracle (``ref.py``), for tests.

There is no fallback: a CUDA tensor under ``"fused"`` launches the
kernel or raises.  The launch goes through ``cuda.FlashAttention``,
whose backward differentiates the plain path; with grad mode off or no
input that requires grad (serving) it records no graph, and launches
the kernel once all the same.  The reference's ``"xla_unroll"`` (its cost-probe mode) has no
counterpart.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda, plain, ref

__all__ = ["IMPLS", "flash_attention"]

IMPLS = ("fused", "chain", "ref")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, impl: str = "fused",
                    **kw) -> torch.Tensor:
    """q (B, T, H, Dh), k and v (B, S, Hkv, Dh) -> (B, T, H, Dh) in q's
    dtype.  ``kw`` (``block_q``, ``block_k``) goes to the plain path."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}: one of {IMPLS}")
    if impl == "ref":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    if impl == "fused" and q.is_cuda:
        return cuda.FlashAttention.apply(q, k, v, causal, window, q_offset)
    return plain.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, **kw)
