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


def settle(x: torch.Tensor) -> torch.Tensor:
    """Over a mesh, the residual stream's placement for ``x`` (a sublayer's
    output before it joins the stream): its batch split over the data
    (and pod) axes, every other dimension whole on each rank, so the
    partial sums a matmul over a split dimension leaves are all-reduced
    here (the row-parallel reduction of tensor parallelism), not left to
    the next op to place as it likes.  Its gradient takes the same
    placement in backward: the residual stream's gradient, partial over
    ``"model"`` where a column-parallel product's input gradient joined
    it, is all-reduced here, so the sublayer's backward products run on
    each rank's split (left partial, DTensor would gather a split weight
    or activation whole and multiply it on every rank).  A plain tensor
    is returned as it is."""
    if not hasattr(x, "device_mesh"):
        return x
    from torch.distributed.tensor import DTensor
    from ..sharding.rules import constrain_batch
    y = constrain_batch(x, x.device_mesh)
    # identity forward; backward redistributes the gradient to y's
    # placements (from_local's backward)
    return DTensor.from_local(y.to_local(), y.device_mesh, y.placements,
                              run_check=False, shape=y.shape,
                              stride=y.stride())


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
    q, k_new, v_new = _proj_qkv(cfg, p, x)          # T == 1
    positions = torch.tensor([pos], device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)
    if hasattr(q, "device_mesh"):
        o = _decode_on_mesh(q, k_new, v_new, cache, pos, window)
    else:
        o = _decode_core(q, k_new, v_new, cache["k"], cache["v"],
                         cache.get("kpos"), pos, window)
    out = torch.einsum("bthk,hkd->btd", o.to(dt), p["wo"].to(dt))
    return out, cache


def _decode_core(q, k_new, v_new, k, v, kpos, pos: int,
                 window: Optional[int], lo: int = 0, seq: int = 0,
                 group=None) -> torch.Tensor:
    """:func:`decode_attention` on plain tensors, from the cache write to
    the heads' output (B, 1, H, Dh) in q's dtype.  ``k``/``v`` hold cache
    slots ``lo .. lo + S_l`` of ``seq`` (all of them by default); with
    ``group`` the other slots lie on its other ranks, and the softmax is
    split: each rank's max, sum and weighted values are combined by
    all-reduces (max, sum, sum) over the group."""
    b, _, h, dh = q.shape
    s_l = k.shape[1]
    seq = seq or s_l
    slot = pos % seq if window is not None else min(pos, seq - 1)
    if lo <= slot < lo + s_l:
        k[:, slot - lo] = k_new[:, 0].to(k.dtype)
        v[:, slot - lo] = v_new[:, 0].to(v.dtype)
    if window is not None:
        kpos[slot] = pos
        kp = kpos[lo: lo + s_l]
        mask = (kp <= pos) & (kp > pos - window) & (kp >= 0)
    else:
        mask = torch.arange(lo, lo + s_l, device=q.device) <= pos
    hkv = k.shape[2]
    qq = q.reshape(b, 1, hkv, h // hkv, dh).float()
    sc = torch.einsum("bthgd,bshd->bhgts", qq, k.float()) / math.sqrt(dh)
    sc = torch.where(mask, sc, -1e30)
    if group is None:
        pr = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgts,bshd->bthgd", pr, v.float())
        return o.reshape(b, 1, h, dh).to(q.dtype)
    import torch.distributed as dist
    m = sc.amax(-1, keepdim=True)
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    pr = torch.exp(sc - m_all) * mask
    total = pr.sum(-1, keepdim=True)
    dist.all_reduce(total, group=group)
    o = torch.einsum("bhgts,bshd->bthgd", pr, v.float())
    dist.all_reduce(o, group=group)
    o = o / total.permute(0, 3, 1, 2, 4)
    return o.reshape(b, 1, h, dh).to(q.dtype)


def _decode_on_mesh(q, k_new, v_new, cache: Dict, pos: int,
                    window: Optional[int]) -> torch.Tensor:
    """:func:`decode_attention`'s core over a mesh: every rank takes all
    heads of its batch rows (q, k_new and v_new gathered over
    ``"model"``), and the cache stays where it is placed, written in
    place on the rank that holds the new slot; a cache whose positions
    are split over ``"model"`` (the dry-run's ``kv_seq``) takes the
    split softmax of :func:`_decode_core`, and one whose KV heads are
    split there (a prefill's over a mesh) is read by each rank with its
    own query heads, the output's heads split as they are."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    k = cache["k"]
    at = k.placements[names.index("model")] if "model" in names \
        else Replicate()
    rows = list(k.placements) if at == Shard(2) else \
        [Replicate() if n == "model" else pl
         for n, pl in zip(names, k.placements)]
    split = at == Shard(1)
    group = mesh.get_group("model") if split else None
    m = mesh.size(names.index("model")) if split else 1
    q, k_new, v_new = (t.redistribute(mesh, rows) for t in (q, k_new, v_new))
    kpos = cache.get("kpos")

    def local(ql, knl, vnl, kl, vl, *kposl):
        lo = mesh.get_local_rank("model") * kl.shape[1] if split else 0
        return _decode_core(ql, knl, vnl, kl, vl, kposl[0] if kposl else None,
                            pos, window, lo=lo, seq=kl.shape[1] * m,
                            group=group)
    args = (q, k_new, v_new, k, cache["v"]) + (() if kpos is None else
                                                (kpos,))
    return local_map(local, out_placements=rows,
                     in_placements=tuple(list(a.placements) for a in args),
                     device_mesh=mesh)(*args)


def mlp(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or the gelu MLP with biases (``jax.nn.gelu``'s default,
    the tanh approximation; reference ``layers.py:145-151``)."""
    dt = cdt(cfg)
    if cfg.act == "silu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
        return h @ p["wo"].to(dt)
    h = F.gelu(x @ p["wi"].to(dt) + p["bi"].to(dt), approximate="tanh")
    return settle(h @ p["wo"].to(dt)) + p["bo"].to(dt)
