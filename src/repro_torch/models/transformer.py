"""Model assembly: block dispatch, the layer loop, forward/prefill/decode.

The counterpart of the reference's ``repro/models/transformer.py``, every
block kind of its ``apply_block`` (``:45-141``).  The reference scans
over stacked layer groups (``jax.lax.scan``), then runs the remainder
layers unrolled (recurrentgemma's 26 = 8·3 + 2), and wraps the scanned
body in ``jax.checkpoint`` for training; here the layers are an
``nn.ModuleList`` in layer order, :func:`apply_stack` is a plain loop,
and in train mode with grad enabled each layer the reference scans runs
under ``torch.utils.checkpoint`` as ``cfg.remat_policy`` says
(:func:`_remat`).  ``cfg.seq_shard`` changes nothing, as the reference's
constraint does outside a mesh.  ``params`` is a
:class:`~.model.Model`: its ``embed``, ``final_norm``, optional
``unembed``, ``blocks``, ``img_proj`` (VLM) and ``encoder`` (whose own
``blocks`` the same loop runs, :func:`_context`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from . import layers as L
from . import moe as M
from . import rglru as RG
from . import rwkv6 as RW
from .kvcache import Caches

_aten = torch.ops.aten
# the matmul outputs that remat_policy="dots" keeps (the counterpart of
# jax.checkpoint_policies.checkpoint_dots)
DOTS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default)


def apply_block(cfg: ArchConfig, kind: str, p, x: torch.Tensor,
                ctx: Dict[str, Any], cache: Optional[Dict],
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache_or_None, aux_loss): the auxiliary loss is a
    zero fp32 scalar but for a ``"moe"`` block's router loss."""
    mode = ctx["mode"]              # train | prefill | decode
    impl = ctx["impl"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Optional[Dict] = None

    if kind in ("attn", "local", "moe", "enc", "dec"):
        h = L.norm(cfg, p["ln1"], x)
        window = cfg.window if kind == "local" else None
        if mode == "decode":
            a, new_cache = L.decode_attention(cfg, p["attn"], h, cache,
                                              ctx["pos"], window=window)
        else:
            a, kv = L.attention(cfg, p["attn"], h,
                                positions=ctx["positions"],
                                causal=kind != "enc", window=window,
                                impl=impl)
            if mode == "prefill" and kind != "enc":
                new_cache = _build_cache(kind, kv, window)
        x = x + L.settle(a)
        if kind == "dec":
            h = L.norm(cfg, p["lnx"], x)
            if mode == "decode":
                a, _ = L.cross_attention(cfg, p["xattn"], h, None, impl=impl,
                                         kv=(cache["xk"], cache["xv"]))
            else:
                a, xkv = L.cross_attention(cfg, p["xattn"], h,
                                           ctx["enc_out"], impl=impl)
                if mode == "prefill":
                    new_cache["xk"] = xkv["k"].to(torch.bfloat16)
                    new_cache["xv"] = xkv["v"].to(torch.bfloat16)
            x = x + L.settle(a)
        h = L.norm(cfg, p["ln2"], x)
        if kind == "moe":
            f, aux = M.moe_ffn(cfg, p["moe"], h)
        else:
            f = L.mlp(cfg, p["mlp"], h)
        return x + L.settle(f), new_cache, aux

    if kind == "cross":
        h = L.norm(cfg, p["ln1"], x)
        if mode == "decode":
            a, _ = L.cross_attention(cfg, p["xattn"], h, None, impl=impl,
                                     kv=(cache["k"], cache["v"]))
            new_cache = cache
        else:
            a, xkv = L.cross_attention(cfg, p["xattn"], h, ctx["img"],
                                       impl=impl)
            if mode == "prefill":
                new_cache = {"k": xkv["k"].to(torch.bfloat16),
                             "v": xkv["v"].to(torch.bfloat16)}
        x = x + torch.tanh(p["gate"].to(x.dtype)) * L.settle(a)
        h = L.norm(cfg, p["ln2"], x)
        return x + L.settle(L.mlp(cfg, p["mlp"], h)), new_cache, aux

    if kind == "rglru":
        h = L.norm(cfg, p["ln1"], x)
        rec_cache = None
        if mode != "train":
            rec_cache = cache if cache is not None else _zero_rec(cfg, x)
        a, new_cache = RG.rglru_block(cfg, p["rec"], h, cache=rec_cache)
        x = x + L.settle(a)
        h = L.norm(cfg, p["ln2"], x)
        return x + L.settle(L.mlp(cfg, p["mlp"], h)), new_cache, aux

    if kind == "rwkv":
        h = L.norm(cfg, p["ln1"], x)
        if mode == "decode":
            a, s_new, sh_t = RW.rwkv_time_mix_step(
                cfg, p["mix"], h, state=cache["s"],
                shift_prev=cache["shift_t"])
        else:
            a, s_new, sh_t = RW.rwkv_time_mix(cfg, p["mix"], h)
        x = x + L.settle(a)
        h = L.norm(cfg, p["ln2"], x)
        f, sh_c = RW.rwkv_channel_mix(
            cfg, p["mix"], h,
            shift_prev=cache["shift_c"] if mode == "decode" else None)
        x = x + L.settle(f)
        if mode != "train":
            new_cache = {"s": s_new, "shift_t": sh_t, "shift_c": sh_c}
        return x, new_cache, aux

    raise ValueError(kind)


def _zero_rec(cfg: ArchConfig, x: torch.Tensor) -> Dict:
    """An RG-LRU prefill's starting state: zeros, not None (reference
    ``:144-148``), so the prefill returns its cache."""
    R = cfg.d_rnn or cfg.d_model
    return {"h": torch.zeros((x.shape[0], R), dtype=torch.float32,
                             device=x.device),
            "conv": torch.zeros((x.shape[0], cfg.conv_width - 1, R),
                                dtype=torch.bfloat16, device=x.device)}


def _build_cache(kind: str, kv: Dict, window: Optional[int]) -> Dict:
    """Prefill keys/values (B, T, Hkv, Dh) as the serving cache: bf16
    whatever the compute dtype, as in the reference (``:151-166``).  A
    ``"local"`` block keeps a ring of ``window`` slots: slot i holds
    position ``(T-1) - ((T-1-i) % window)``, the newest one congruent to
    i, with ``kpos`` that position; a slot no position reached is zero
    with ``kpos`` -1."""
    k, v = kv["k"].to(torch.bfloat16), kv["v"].to(torch.bfloat16)
    if kind != "local":
        return {"k": k, "v": v}
    T = k.shape[1]
    w = window or T              # ring always has `window` slots
    i = torch.arange(w, device=k.device)
    pidx = (T - 1) - ((T - 1 - i) % w)
    valid = pidx >= 0
    safe = torch.clamp(pidx, 0, T - 1)
    keep = valid[None, :, None, None]
    return {"k": k[:, safe] * keep, "v": v[:, safe] * keep,
            "kpos": torch.where(valid, pidx, -1).to(torch.int32)}


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
                pattern: Optional[Tuple[str, ...]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Caches]]:
    """Runs ``params.blocks`` in order.  Returns (x, aux_total,
    new_caches): a cache a layer in prefill and decode, None in the full
    forward.  The layers' kinds are ``cfg.layer_kinds()`` (the pattern's
    groups, then the unrolled remainder), or ``pattern`` repeated over
    the blocks (the encoder's ``("enc",)``).  In train mode with grad
    enabled, the layers the reference scans (the whole groups) run under
    :func:`_remat`; the remainder layers do not, as in the reference."""
    if pattern is None:
        kinds = cfg.layer_kinds()
        scanned = cfg.n_groups * len(cfg.pattern)
    else:
        kinds = pattern * (len(params.blocks) // len(pattern))
        scanned = len(kinds)
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    train = ctx["mode"] == "train" and torch.is_grad_enabled()
    for i, (kind, p) in enumerate(zip(kinds, params.blocks)):
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
    table.  Over a mesh a vocabulary-sharded table is read in place, each
    rank its own rows (:func:`_vocab_parallel_rows`), not gathered."""
    table = params.embed["tok"]
    if hasattr(table, "device_mesh") and table.placements != \
            type(table.placements)(_replicated(table)):
        return L.settle(_vocab_parallel_rows(tokens, table)).to(L.cdt(cfg))
    return L.settle(F.embedding(tokens, table)).to(L.cdt(cfg))


def _replicated(t) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * t.device_mesh.ndim


def _vocab_parallel_rows(tokens, table):
    """The embedding of ``tokens`` (split over the batch axes) from a
    ``table`` whose rows are split over ``"model"`` (and whole over the
    other axes): each rank looks up the tokens its rows hold, zeros for
    the others, and the result is a partial sum over ``"model"``; each
    rank's gradient lands on its own rows, partial over the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    tok_place = list(tokens.placements)
    out_place = [Partial() if n == "model" else p
                 for n, p in zip(names, tok_place)]
    grad_place = [Partial() if isinstance(p, Shard) else q
                  for p, q in zip(tok_place, table.placements)]

    def rows(tok, tab):
        lo = mesh.get_local_rank("model") * tab.shape[0]
        inside = (tok >= lo) & (tok < lo + tab.shape[0])
        out = F.embedding(torch.where(inside, tok - lo, 0), tab)
        return out * inside[..., None].to(out.dtype)

    return local_map(rows, out_placements=out_place,
                     in_placements=(tok_place, list(table.placements)),
                     in_grad_placements=(tok_place, grad_place),
                     device_mesh=mesh)(tokens, table)


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits, through the tied embedding or the unembedding."""
    xf = x.float()
    if cfg.tie_embeddings:
        return xf @ params.embed["tok"].T
    return xf @ params.unembed["w"]


def _context(cfg: ArchConfig, params, batch: Dict, mode: str,
             impl: str) -> Dict[str, Any]:
    """Modality frontends (reference ``:258-278``): the image embeds
    projected by ``img_proj``, or the audio embeds through ``in_proj``,
    the encoder's (non-causal) stack in train mode and its final norm.
    In decode the cross keys and values live in the cache, so neither is
    computed."""
    ctx: Dict[str, Any] = {"mode": mode, "impl": impl}
    if mode == "decode":
        return ctx
    dt = L.cdt(cfg)
    if "image_embeds" in batch:
        img = batch["image_embeds"].to(dt)
        ctx["img"] = L.settle(img @ params.img_proj["w"].to(dt))
    if "audio_embeds" in batch:
        enc = params.encoder
        h = L.settle(batch["audio_embeds"].to(dt) @ enc.in_proj["w"].to(dt))
        ectx = {"mode": "train", "impl": impl,
                "positions": torch.arange(h.shape[1], device=h.device)}
        h, _, _ = apply_stack(cfg, enc, h, ectx, pattern=("enc",))
        ctx["enc_out"] = L.norm(cfg, enc.final_norm, h)
    return ctx


def forward_hidden(cfg: ArchConfig, params, batch: Dict, *,
                   impl: str = "fused") -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward: (final-norm hidden state (B, T, D), aux_loss)."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    ctx = _context(cfg, params, batch, "train", impl)
    ctx["positions"] = torch.arange(tokens.shape[1], device=x.device)
    x, aux, _ = apply_stack(cfg, params, x, ctx)
    return L.norm(cfg, params.final_norm, x), aux


def forward(cfg: ArchConfig, params, batch: Dict, *,
            impl: str = "fused") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: (logits (B, T, V) in fp32, aux_loss)."""
    hidden, aux = forward_hidden(cfg, params, batch, impl=impl)
    return logits_fn(cfg, params, hidden), aux


def prefill(cfg: ArchConfig, params, batch: Dict, *,
            impl: str = "fused") -> Tuple[torch.Tensor, Caches]:
    """Prefill: returns (last-position logits (B, V), caches)."""
    tokens = batch["tokens"]
    x = embed(cfg, params, tokens)
    ctx = _context(cfg, params, batch, "prefill", impl)
    ctx["positions"] = torch.arange(tokens.shape[1], device=x.device)
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
