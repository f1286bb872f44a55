"""Model assembly: block dispatch, the layer loop, forward/prefill/decode.

The counterpart of the reference's ``repro/models/transformer.py`` for the
dense ``"attn"`` block.  The reference scans over stacked layer groups
(``jax.lax.scan``) and wraps the scanned body in ``jax.checkpoint`` for
training; here the layers are an ``nn.ModuleList``, :func:`apply_stack`
is a plain loop, and in train mode with grad enabled each scanned layer
runs under ``torch.utils.checkpoint`` as ``cfg.remat_policy`` says
(:func:`_remat`).  ``cfg.seq_shard`` changes nothing, as the reference's
constraint does outside a mesh.  ``params`` is a
:class:`~.model.Model`: its ``embed``, ``final_norm``, optional
``unembed`` and ``blocks``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from . import layers as L
from .kvcache import Caches

_aten = torch.ops.aten
# the matmul outputs that remat_policy="dots" keeps (the counterpart of
# jax.checkpoint_policies.checkpoint_dots)
DOTS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default)


def apply_block(cfg: ArchConfig, kind: str, p, x: torch.Tensor,
                ctx: Dict[str, Any], cache: Optional[Dict],
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache_or_None, aux_loss): a dense block's auxiliary
    loss is a zero fp32 scalar."""
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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + L.mlp(cfg, p["mlp"], h), new_cache, aux


def _build_cache(kv: Dict) -> Dict:
    """Prefill keys/values (B, T, Hkv, Dh) as the serving cache: bf16
    whatever the compute dtype, as in the reference."""
    return {"k": kv["k"].to(torch.bfloat16), "v": kv["v"].to(torch.bfloat16)}


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, fn):
    """``fn`` under the config's remat policy: ``"none"`` as it is,
    ``"dots"`` a selective checkpoint that saves the matmul outputs and
    recomputes the rest, anything else (``"full"``) a plain checkpoint,
    as the reference's ``_remat``."""
    if cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def apply_stack(cfg: ArchConfig, params, x: torch.Tensor,
                ctx: Dict[str, Any], caches: Optional[Caches] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Caches]]:
    """Returns (x, aux_total, new_caches): a cache a layer in prefill and
    decode, None in the full forward.  In train mode with grad enabled,
    the layers the reference scans (``n_groups * len(pattern)``, all of
    a dense stack) run under :func:`_remat`; the remainder layers do
    not, as in the reference."""
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    train = ctx["mode"] == "train" and torch.is_grad_enabled()
    scanned = cfg.n_groups * len(cfg.pattern)
    for i, (kind, p) in enumerate(zip(cfg.layer_kinds(), params.blocks)):
        cache = caches[i] if caches is not None else None
        if train and i < scanned:
            def layer(h, kind=kind, p=p):
                out, _, aux = apply_block(cfg, kind, p, h, ctx, None)
                return out, aux
            x, a = _remat(cfg, layer)(x)
            c = None
        else:
            x, c, a = apply_block(cfg, kind, p, x, ctx, cache)
        aux_total = aux_total + a
        new_caches.append(c)
    return x, aux_total, (new_caches if ctx["mode"] != "train" else None)


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
                   impl: str = "fused") -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward: (final-norm hidden state (B, T, D), aux_loss)."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    ctx = {"mode": "train", "impl": impl,
           "positions": torch.arange(tokens.shape[1], device=x.device)}
    x, aux, _ = apply_stack(cfg, params, x, ctx)
    return L.norm(cfg, params.final_norm, x), aux


def forward(cfg: ArchConfig, params, batch: Dict, *,
            impl: str = "fused") -> torch.Tensor:
    """Full forward: logits (B, T, V) in fp32.  (The reference also
    returns the auxiliary loss, which dense blocks make zero.)"""
    hidden, _ = forward_hidden(cfg, params, batch, impl=impl)
    return logits_fn(cfg, params, hidden)


def prefill(cfg: ArchConfig, params, batch: Dict, *,
            impl: str = "fused") -> Tuple[torch.Tensor, Caches]:
    """Prefill: returns (last-position logits (B, V), caches)."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    ctx = {"mode": "prefill", "impl": impl,
           "positions": torch.arange(tokens.shape[1], device=x.device)}
    x, _, caches = apply_stack(cfg, params, x, ctx)
    x = L.norm(cfg, params.final_norm, x[:, -1:])
    return logits_fn(cfg, params, x)[:, 0], caches


def decode_step(cfg: ArchConfig, params, caches: Caches,
                tokens: torch.Tensor, pos: int, *,
                impl: str = "fused") -> Tuple[torch.Tensor, Caches]:
    """One decode step.  tokens: (B, 1); pos: the absolute position."""
    x = embed(cfg, params, tokens)
    ctx = {"mode": "decode", "impl": impl, "pos": pos}
    x, _, new_caches = apply_stack(cfg, params, x, ctx, caches=caches)
    x = L.norm(cfg, params.final_norm, x)
    return logits_fn(cfg, params, x)[:, 0], new_caches
