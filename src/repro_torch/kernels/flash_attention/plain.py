"""Plain PyTorch flash attention: blocked online softmax.

The counterpart of the reference's XLA path
(``repro/kernels/flash_attention/ops.py::flash_attention_xla``) and the
function the CUDA kernel (``cuda.py``, ``csrc/flash_attention.cu``) is
held to.  q is padded to whole ``block_q`` blocks and k, v to whole
``block_k`` blocks; for each q block the kv blocks are folded in order
into an fp32 running max ``m``, sum ``l`` and accumulator, with scores
``q·k * (1/sqrt(Dh))`` in fp32 from upcast inputs, ``-1e30`` where the
masks (``kpos < S``, causal ``kpos <= qpos``, window
``kpos > qpos - window``, ``qpos = q_offset + row``) exclude a key; the
output is ``acc / max(l, 1e-30)`` in q's dtype.  Memory stays
O(B·H·block_q·block_k).  Every kv block is visited, masked or not, as
in the reference.

Under autograd (grad mode on and an input that requires grad) the
backward keeps that bound as the reference's does (``ops.py:51``,
``:85-94`` there, ``jax.checkpoint`` on both scan bodies): each q block
runs under ``torch.utils.checkpoint`` and each kv step inside it too, so
backward recomputes the (block_q, block_k) score blocks instead of
saving all of them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
DEFAULT_BQ = 512   # the reference XLA path's blocks
DEFAULT_BK = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, block_q: int = DEFAULT_BQ,
                    block_k: int = DEFAULT_BK) -> torch.Tensor:
    """q: (B, T, H, Dh); k, v: (B, S, Hkv, Dh).  Returns (B, T, H, Dh)."""
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} KV heads")
    g = h // hkv
    block_q = min(block_q, t)
    block_k = min(block_k, s)
    nq = -(-t // block_q)
    nk = -(-s // block_k)
    dev = q.device
    qg = F.pad(q, (0, 0, 0, 0, 0, nq * block_q - t)).float() \
        .reshape(b, nq, block_q, hkv, g, dh)
    kg = F.pad(k, (0, 0, 0, 0, 0, nk * block_k - s)).float() \
        .reshape(b, nk, block_k, hkv, dh)
    vg = F.pad(v, (0, 0, 0, 0, 0, nk * block_k - s)).float() \
        .reshape(b, nk, block_k, hkv, dh)
    scale = 1.0 / math.sqrt(dh)
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def kv_step(m, l, acc, qblk, kblk, vblk, qpos, j):
        kpos = j * block_k + torch.arange(block_k, device=dev)
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk) * scale
        mask = (kpos[None, :] < s)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        sc = torch.where(mask, sc, NEG_INF)
        m_c = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_c)
        p = torch.exp(sc - m_c[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vblk)
        return m_c, l, acc

    def q_block(qblk, kg, vg, i):
        qpos = q_offset + i * block_q + torch.arange(block_q, device=dev)
        m = torch.full((b, hkv, g, block_q), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, block_q), device=dev)
        acc = torch.zeros((b, hkv, g, block_q, dh), device=dev)
        for j in range(nk):
            m, l, acc = run(kv_step, m, l, acc, qblk, kg[:, j], vg[:, j],
                            qpos, j)
        return acc / torch.clamp(l, min=1e-30)[..., None]

    blocks = [run(q_block, qg[:, i], kg, vg, i) for i in range(nq)]
    # (nq, B, Hkv, G, BQ, Dh) -> (B, T, H, Dh)
    out = torch.stack(blocks).permute(1, 0, 4, 2, 3, 5) \
        .reshape(b, nq * block_q, h, dh)[:, :t]
    return out.to(q.dtype)
