"""Model assembly: block dispatch, the layer loop, forward/prefill/decode.

The counterpart of the reference's ``repro/models/transformer.py`` for the
dense ``"attn"`` block.  The reference scans over stacked layer groups
(``jax.lax.scan``, with remat for training); here the layers are an
``nn.ModuleList`` and :func:`apply_stack` is a plain loop, with no remat
(training waits).  ``params`` is a :class:`~.model.Model`: its ``embed``,
``final_norm``, optional ``unembed`` and ``blocks``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import layers as L
from .kvcache import Caches


def apply_block(cfg: ArchConfig, kind: str, p, x: torch.Tensor,
                ctx: Dict[str, Any], cache: Optional[Dict],
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x, new_cache_or_None)."""
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP Queue 1, "
            "item 4c)")
    mode = ctx["mode"]              # train | prefill | decode
    new_cache: Optional[Dict] = None
    h = L.norm(cfg, p["ln1"], x)
    if mode == "decode":
        a, new_cache = L.decode_attention(cfg, p["attn"], h, cache,
                                          ctx["pos"])
    else:
        a, kv = L.attention(cfg, p["attn"], h, positions=ctx["positions"],
                            impl=ctx["impl"])
        if mode == "prefill":
            new_cache = _build_cache(kv)
    x = x + a
    h = L.norm(cfg, p["ln2"], x)
    return x + L.mlp(cfg, p["mlp"], h), new_cache


def _build_cache(kv: Dict) -> Dict:
    """Prefill keys/values (B, T, Hkv, Dh) as the serving cache: bf16
    whatever the compute dtype, as in the reference."""
    return {"k": kv["k"].to(torch.bfloat16), "v": kv["v"].to(torch.bfloat16)}


def apply_stack(cfg: ArchConfig, params, x: torch.Tensor,
                ctx: Dict[str, Any], caches: Optional[Caches] = None,
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
    """Returns (x, new_caches): a cache a layer in prefill and decode,
    None in the full forward."""
    new_caches = []
    for i, (kind, p) in enumerate(zip(cfg.layer_kinds(), params.blocks)):
        x, c = apply_block(cfg, kind, p, x, ctx,
                           caches[i] if caches is not None else None)
        new_caches.append(c)
    return x, (new_caches if ctx["mode"] != "train" else None)


def embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the fp32 table, in the compute dtype.  The
    reference casts the whole table and then gathers; gathering first
    gives the same values (the cast is elementwise) without a copy of the
    table."""
    return params.embed["tok"][tokens].to(L.cdt(cfg))


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits, through the tied embedding or the unembedding."""
    xf = x.float()
    if cfg.tie_embeddings:
        return xf @ params.embed["tok"].T
    return xf @ params.unembed["w"]


def forward_hidden(cfg: ArchConfig, params, batch: Dict, *,
                   impl: str = "fused") -> torch.Tensor:
    """Backbone forward: the final-norm hidden state (B, T, D)."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    ctx = {"mode": "train", "impl": impl,
           "positions": torch.arange(tokens.shape[1], device=x.device)}
    x, _ = apply_stack(cfg, params, x, ctx)
    return L.norm(cfg, params.final_norm, x)


def forward(cfg: ArchConfig, params, batch: Dict, *,
            impl: str = "fused") -> torch.Tensor:
    """Full forward: logits (B, T, V) in fp32.  (The reference also
    returns an auxiliary loss, which dense blocks make zero.)"""
    return logits_fn(cfg, params, forward_hidden(cfg, params, batch,
                                                 impl=impl))


def prefill(cfg: ArchConfig, params, batch: Dict, *,
            impl: str = "fused") -> Tuple[torch.Tensor, Caches]:
    """Prefill: returns (last-position logits (B, V), caches)."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    ctx = {"mode": "prefill", "impl": impl,
           "positions": torch.arange(tokens.shape[1], device=x.device)}
    x, caches = apply_stack(cfg, params, x, ctx)
    x = L.norm(cfg, params.final_norm, x[:, -1:])
    return logits_fn(cfg, params, x)[:, 0], caches


def decode_step(cfg: ArchConfig, params, caches: Caches,
                tokens: torch.Tensor, pos: int, *,
                impl: str = "fused") -> Tuple[torch.Tensor, Caches]:
    """One decode step.  tokens: (B, 1); pos: the absolute position."""
    x = embed(cfg, params, tokens)
    ctx = {"mode": "decode", "impl": impl, "pos": pos}
    x, new_caches = apply_stack(cfg, params, x, ctx, caches=caches)
    x = L.norm(cfg, params.final_norm, x)
    return logits_fn(cfg, params, x)[:, 0], new_caches
