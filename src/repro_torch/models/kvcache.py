"""Serving caches per block kind.

The counterpart of the reference's ``repro/models/kvcache.py``, with its
shapes and dtypes (``block_cache_shapes``, ``:19-54``): dense causal
blocks keep (B, S, Hkv, Dh) bf16 key/value buffers; sliding-window
blocks keep a W-slot ring plus the absolute position of each slot
(``kpos``, -1 while empty); cross blocks keep the image tokens' keys
and values; RG-LRU blocks keep their fp32 state and bf16 conv tail,
RWKV blocks their fp32 state and token shifts; decoder blocks keep the
encoder output's keys and values (``xk``/``xv``, ``n_heads`` of them)
beside their own.  One dict a layer, in a list in layer order (the
reference stacks them per pattern group).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig

Caches = List[Dict[str, torch.Tensor]]


def block_cache_shapes(cfg: ArchConfig, kind: str, batch: int,
                       seq: int) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of one block's cache."""
    Hkv, dh, D = cfg.n_kv_heads, cfg.dh, cfg.d_model
    bf, f32 = torch.bfloat16, torch.float32
    if kind in ("attn", "moe"):
        return {"k": ((batch, seq, Hkv, dh), bf),
                "v": ((batch, seq, Hkv, dh), bf)}
    if kind == "local":
        w = cfg.window or seq        # ring always has `window` slots
        return {"k": ((batch, w, Hkv, dh), bf),
                "v": ((batch, w, Hkv, dh), bf),
                "kpos": ((w,), torch.int32)}
    if kind == "cross":
        n = cfg.n_image_tokens
        return {"k": ((batch, n, Hkv, dh), bf),
                "v": ((batch, n, Hkv, dh), bf)}
    if kind == "rglru":
        R = cfg.d_rnn or D
        return {"h": ((batch, R), f32),
                "conv": ((batch, cfg.conv_width - 1, R), bf)}
    if kind == "rwkv":
        dh_r = cfg.rwkv_head_dim
        return {"s": ((batch, D // dh_r, dh_r, dh_r), f32),
                "shift_t": ((batch, D), f32),
                "shift_c": ((batch, D), f32)}
    if kind == "dec":
        enc = cfg.encoder_seq
        return {"k": ((batch, seq, Hkv, dh), bf),
                "v": ((batch, seq, Hkv, dh), bf),
                "xk": ((batch, enc, cfg.n_heads, dh), bf),
                "xv": ((batch, enc, cfg.n_heads, dh), bf)}
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, seq: int,
               device: torch.device) -> Caches:
    """Caches for ``seq`` positions: zeros, and -1 in every ``kpos``."""
    def make(shape, dtype):
        if dtype == torch.int32:            # kpos arrays start invalid
            return torch.full(shape, -1, dtype=dtype, device=device)
        return torch.zeros(shape, dtype=dtype, device=device)
    return [{name: make(*sd) for name, sd in
             block_cache_shapes(cfg, kind, batch, seq).items()}
            for kind in cfg.layer_kinds()]


def pad_caches(cfg: ArchConfig, caches: Caches, extra: int) -> Caches:
    """Extend the dense KV caches (``k``/``v`` of ``attn``, ``moe`` and
    ``dec`` blocks) by ``extra`` zeroed sequence slots, after prefill, so
    decode can append (reference ``:85-104``).  Ring, cross, recurrent
    caches and ``xk``/``xv`` keep their size."""
    out = []
    for kind, c in zip(cfg.layer_kinds(), caches):
        c = dict(c)
        if kind in ("attn", "moe", "dec"):
            for key in ("k", "v"):
                c[key] = _pad_seq(c[key], extra)
        out.append(c)
    return out


def _pad_seq(t: torch.Tensor, extra: int) -> torch.Tensor:
    """``t`` (B, S, ...) with ``extra`` zeroed slots after its S.  A
    DTensor whose sequence is whole on each rank (a prefill's over a
    mesh) pads each rank's shard: DTensor's own pad redistributes first,
    and fails in PyTorch 2.11."""
    pad = (0, 0, 0, 0, 0, extra)
    if not hasattr(t, "device_mesh") or any(p.is_shard(1)
                                             for p in t.placements):
        return F.pad(t, pad)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(F.pad(t.to_local(), pad), t.device_mesh,
                              t.placements, run_check=False)
