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

Over a mesh (DTensor q, k, v: training on several ranks) attention runs
on each rank's own heads (:func:`_on_local_heads`): q is split over
``"model"`` on its head dimension when that divides the heads, its batch
over ``("pod", "data")`` as the batch is, and the kernel (or the plain
path) runs unchanged on the local tensors through ``local_map``.  When
the KV heads do not divide the model axis the rules replicate k and v;
each rank then reads the KV heads of its own query heads
(:func:`kv_group`), and their gradients come back partial over
``"model"`` (each rank's share of the KV group's gradient).
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
    if hasattr(q, "device_mesh"):
        return _on_local_heads(q, k, v, dict(causal=causal, window=window,
                                             q_offset=q_offset, impl=impl,
                                             **kw))
    if impl == "ref":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    if impl == "fused" and q.is_cuda:
        return cuda.FlashAttention.apply(q, k, v, causal, window, q_offset)
    return plain.flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, **kw)


def kv_group(h: int, hkv: int, h0: int, hl: int):
    """The KV heads that query heads ``h0 .. h0 + hl - 1`` of ``h`` read
    (GQA: query head i reads KV head ``i // (h // hkv)``), as an index
    into the ``hkv`` KV heads that keeps the kernel's head map right: a
    slice of whole groups (``hl`` a multiple of the group, or all ``hl``
    in one group), else one KV head a query head."""
    g = h // hkv
    first, last = h0 // g, (h0 + hl - 1) // g
    if hl % g == 0 or first == last:
        return slice(first, last + 1)
    return [(h0 + i) // g for i in range(hl)]


def _on_local_heads(q, k, v, kw):
    """:func:`flash_attention` of DTensors, on each rank's local heads."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ...sharding import rules

    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    b, h, hkv = q.shape[0], q.shape[2], k.shape[2]
    m = mesh.size(names.index("model")) if "model" in names else 1
    q_split = m > 1 and h % m == 0
    kv_split = q_split and hkv % m == 0
    batch_axes = rules.batch_sharding(mesh, b)
    batch_axes = rules.target_axes(batch_axes[0]) if batch_axes else ()

    def place(heads: bool, model_grad=None) -> list:
        return [Shard(0) if n in batch_axes else
                (Shard(2) if heads else model_grad or Replicate())
                if n == "model" else Replicate() for n in names]

    q_place, kv_place = place(q_split), place(kv_split)
    kv_grad = place(False, Partial()) if q_split and not kv_split \
        else kv_place

    def local(ql, kl, vl):
        if q_split and not kv_split:
            hl = ql.shape[2]
            sel = kv_group(h, hkv, mesh.get_local_rank("model") * hl, hl)
            if isinstance(sel, list):
                sel = torch.tensor(sel, device=kl.device)
            kl, vl = kl[:, :, sel].contiguous(), vl[:, :, sel].contiguous()
        return flash_attention(ql, kl, vl, **kw)

    return local_map(local, out_placements=q_place,
                     in_placements=(q_place, kv_place, kv_place),
                     in_grad_placements=(q_place, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)
