"""Shared neural layers: norm, rotary embeddings, attention, MLP.

The counterpart of the reference's ``repro/models/layers.py`` for the
dense block (rmsnorm, SwiGLU; the audio family's layernorm and gelu wait
with its slice).  Parameters are a block's ``ParameterDict``s (``specs``
names).  Compute dtype is bf16 or fp32 (``cfg.dtype_compute``): params
are fp32 and cast at use; norm and softmax run in fp32.  The bf16
rounding points are the reference's: the norm rounds its fp32 result
to x's dtype, rope rounds its fp32 product back, the QKV bias is added
in the compute dtype after the product.  ``cross_attention`` waits for
the VLM and audio slices.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as fa_ops


def cdt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype_compute == "bfloat16" \
        else torch.float32


def norm(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMS norm in fp32, rounded back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
    return (y * p["scale"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh); positions: (T,) absolute positions."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[:, None] * freq[None, :]
    ang = ang[None, :, None, :]                      # (1, T, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    # x (bf16 or fp32) times fp32 sin/cos promotes to fp32, as in the
    # reference; the result rounds back to x's dtype
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _proj_qkv(cfg: ArchConfig, p, x: torch.Tensor):
    dt = cdt(cfg)
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def attention(cfg: ArchConfig, p, x: torch.Tensor, *,
              positions: torch.Tensor,
              impl: str = "fused") -> Tuple[torch.Tensor, Dict]:
    """Full-sequence causal self attention (prefill and the full forward).

    Returns (output, {"k","v"} roped keys/values for cache construction).
    """
    dt = cdt(cfg)
    q, k, v = _proj_qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # the kernel takes contiguous tensors and copies nothing itself
    o = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, impl=impl)
    out = torch.einsum("bthk,hkd->btd", o, p["wo"].to(dt))
    return out, {"k": k, "v": v}


def decode_attention(cfg: ArchConfig, p, x: torch.Tensor, cache: Dict,
                     pos: int) -> Tuple[torch.Tensor, Dict]:
    """Single-token attention against a dense KV cache.

    ``cache``: {"k","v"}: (B, S, Hkv, Dh).  The new token's key and value
    are written at slot ``min(pos, S - 1)`` *in place* (the reference
    returns an updated copy; the cache dict returned is the one given),
    then the token attends to slots ``<= pos``: dense masked attention in
    fp32, in plain PyTorch (the reference's is no Pallas kernel either).
    """
    dt = cdt(cfg)
    b = x.shape[0]
    q, k_new, v_new = _proj_qkv(cfg, p, x)          # T == 1
    positions = torch.tensor([pos], device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    slot = min(pos, S - 1)
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    mask = torch.arange(S, device=x.device) <= pos
    hkv, dh = k.shape[2], q.shape[-1]
    g = cfg.n_heads // hkv
    qq = q.reshape(b, 1, hkv, g, dh).float()
    sc = torch.einsum("bthgd,bshd->bhgts", qq, k.float()) / math.sqrt(dh)
    sc = torch.where(mask, sc, -1e30)
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", pr, v.float())
    o = o.reshape(b, 1, cfg.n_heads, dh).to(dt)
    out = torch.einsum("bthk,hkd->btd", o, p["wo"].to(dt))
    return out, cache


def mlp(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    dt = cdt(cfg)
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    return h @ p["wo"].to(dt)
