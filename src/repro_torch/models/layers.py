"""Shared neural layers: norms, rotary embeddings, attention, MLP.

The counterpart of the reference's ``repro/models/layers.py``: rmsnorm
and layernorm, SwiGLU and the gelu MLP with biases, self attention
(causal, sliding-window or neither), cross attention to a fixed memory,
and decode attention against a dense or ring KV cache.  Parameters are
a block's ``ParameterDict``s (``specs`` names).  Compute dtype is bf16
or fp32 (``cfg.dtype_compute``): params are fp32 and cast at use; norm
and softmax run in fp32.  The bf16 rounding points are the reference's:
the norm rounds its fp32 result to x's dtype, rope rounds its fp32
product back, the QKV bias is added in the compute dtype after the
product.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as fa_ops


def cdt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype_compute == "bfloat16" \
        else torch.float32


def norm(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMS norm (eps 1e-6) or layernorm (eps 1e-5, with a bias) in fp32,
    rounded back to x's dtype (reference ``layers.py:22-32``)."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
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


def _proj_qkv(cfg: ArchConfig, p, x: torch.Tensor,
              src: Optional[torch.Tensor] = None):
    """q from x, k and v from ``src`` (x by default)."""
    dt = cdt(cfg)
    src = x if src is None else src
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def attention(cfg: ArchConfig, p, x: torch.Tensor, *,
              positions: torch.Tensor, causal: bool = True,
              window: Optional[int] = None,
              impl: str = "fused") -> Tuple[torch.Tensor, Dict]:
    """Full-sequence self attention (prefill and the full forward;
    reference ``layers.py:67-82``).

    Returns (output, {"k","v"} roped keys/values for cache construction).
    """
    dt = cdt(cfg)
    q, k, v = _proj_qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # the kernel takes contiguous tensors and copies nothing itself
    o = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               impl=impl)
    out = torch.einsum("bthk,hkd->btd", o, p["wo"].to(dt))
    return out, {"k": k, "v": v}


def cross_attention(cfg: ArchConfig, p, x: torch.Tensor,
                    kv_src: Optional[torch.Tensor], *, impl: str = "fused",
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> Tuple[torch.Tensor, Dict]:
    """Attention of x to a fixed memory (image embeds, encoder output;
    reference ``layers.py:85-99``): k and v projected from ``kv_src``,
    or given as ``kv`` (the cross cache, bf16), non-causal, nothing
    roped.  Given k and v are cast to q's dtype (the reference's dense
    path promotes; the kernel takes one dtype).  Returns (output,
    {"k","v"})."""
    dt = cdt(cfg)
    if kv is None:
        _, k, v = _proj_qkv(cfg, p, kv_src, src=kv_src)
    else:
        k, v = kv
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    o = fa_ops.flash_attention(q.contiguous(),
                               k.to(q.dtype).contiguous(),
                               v.to(q.dtype).contiguous(), causal=False,
                               impl=impl)
    out = torch.einsum("bthk,hkd->btd", o, p["wo"].to(dt))
    return out, {"k": k, "v": v}


def decode_attention(cfg: ArchConfig, p, x: torch.Tensor, cache: Dict,
                     pos: int, *, window: Optional[int] = None,
                     ) -> Tuple[torch.Tensor, Dict]:
    """Single-token attention against a KV cache (reference
    ``layers.py:102-142``).

    ``cache``: {"k","v"}: (B, S, Hkv, Dh), plus "kpos" (S,) int32 for a
    ring (windowed) cache.  The new token's key and value are written
    *in place* (the reference returns an updated copy; the cache dict
    returned is the one given): at slot ``min(pos, S - 1)`` of a dense
    cache, which then attends to slots ``<= pos``; at slot ``pos % S``
    of a ring, whose ``kpos`` records ``pos`` there, which then attends
    to the slots with ``pos - window < kpos <= pos`` and ``kpos >= 0``.
    Dense masked attention in fp32, in plain PyTorch (the reference's is
    no Pallas kernel either).
    """
    dt = cdt(cfg)
    b = x.shape[0]
    q, k_new, v_new = _proj_qkv(cfg, p, x)          # T == 1
    positions = torch.tensor([pos], device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    S = k.shape[1]
    slot = pos % S if window is not None else min(pos, S - 1)
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    if window is not None:
        kpos = cache["kpos"]
        kpos[slot] = pos
        mask = (kpos <= pos) & (kpos > pos - window) & (kpos >= 0)
    else:
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
    """SwiGLU, or the gelu MLP with biases (``jax.nn.gelu``'s default,
    the tanh approximation; reference ``layers.py:145-151``)."""
    dt = cdt(cfg)
    if cfg.act == "silu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
        return h @ p["wo"].to(dt)
    h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt) + p["bo"].to(dt)
