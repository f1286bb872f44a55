"""Dense oracle for flash attention: naive full-matrix softmax attention.

The counterpart of the reference's ``repro/kernels/flash_attention/ref.py::
attention_ref``.  Shapes: q (B, T, H, Dh); k, v (B, S, Hkv, Dh) with
H % Hkv == 0 (GQA: query head h reads KV head h // (H / Hkv)).
``window``: optional sliding-window size W — the query at absolute
position p attends to keys in (p - W, p] (plus causality).  ``q_offset``
is the absolute position of q[0] (decode / chunked prefill).  Scores are
fp32 from upcast inputs; the output is in q's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} KV heads")
    g = h // hkv
    qq = q.reshape(b, t, hkv, g, dh).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qq, k.float()) / math.sqrt(dh)
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(b, t, h, dh).to(q.dtype)
