"""Serving caches of the dense ``"attn"`` block.

The counterpart of the reference's ``repro/models/kvcache.py`` for dense
causal blocks: (B, S, Hkv, Dh) bf16 key and value buffers, one dict a
layer, in a list in layer order (the reference stacks them per pattern
group).  The ring (sliding-window), recurrent and cross caches wait for
the slices that port their blocks.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig

Caches = List[Dict[str, torch.Tensor]]


def init_cache(cfg: ArchConfig, batch: int, seq: int,
               device: torch.device) -> Caches:
    """Zeroed caches for ``seq`` positions."""
    shape = (batch, seq, cfg.n_kv_heads, cfg.dh)
    out = []
    for kind in cfg.layer_kinds():
        if kind != "attn":
            raise NotImplementedError(
                f"{kind} cache is not ported yet (ROADMAP Queue 1, item 4c)")
        out.append({key: torch.zeros(shape, dtype=torch.bfloat16,
                                     device=device) for key in ("k", "v")})
    return out


def pad_caches(cfg: ArchConfig, caches: Caches, extra: int) -> Caches:
    """Extend the caches by ``extra`` zeroed sequence slots (after
    prefill, so decode can append)."""
    return [{key: F.pad(c[key], (0, 0, 0, 0, 0, extra)) for key in ("k", "v")}
            for c in caches]
