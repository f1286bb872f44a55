"""Parameter specifications: shapes, logical axes and init per architecture.

The counterpart of the reference's ``repro/models/specs.py`` for the dense
``"attn"`` block (rmsnorm, SwiGLU).  The parameter tree is described as data
(``ParamSpec`` leaves, the reference's tree and names, without its
sharding axes, which the port does not use), so the parameter count needs
no allocation; :func:`param_tree` turns a block's or a
model's top-level specs into ``nn.ParameterDict``s with fp32 parameters,
and :func:`init_` fills one from a ``torch.Generator``: normal(0, scale),
ones or zeros, as the reference's init (its numbers differ: a
``torch.Generator`` is not a JAX key).  The MoE, RG-LRU, RWKV, cross and
encoder specs wait for the slices that port their blocks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig

@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 0.02


def _norm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((cfg.d_model,), "ones")}


def _attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    s = {"wq": ParamSpec((D, H, dh)), "wk": ParamSpec((D, Hkv, dh)),
         "wv": ParamSpec((D, Hkv, dh)), "wo": ParamSpec((H, dh, D))}
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, dh), "zeros")
        s["bk"] = ParamSpec((Hkv, dh), "zeros")
        s["bv"] = ParamSpec((Hkv, dh), "zeros")
    return s


def _mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, F = cfg.d_model, cfg.d_ff
    return {"wi": ParamSpec((D, F)), "wo": ParamSpec((F, D)),
            "wg": ParamSpec((D, F))}


def block_specs(cfg: ArchConfig, kind: str) -> Dict:
    """Specs of one transformer block of the given kind."""
    if cfg.norm != "rmsnorm" or cfg.act != "silu":
        raise NotImplementedError(
            f"{cfg.norm} / {cfg.act}: the layernorm and gelu layers of the "
            "audio family are not ported yet (ROADMAP Queue 1, item 4c)")
    if kind == "attn":
        return {"ln1": _norm_specs(cfg), "attn": _attn_specs(cfg),
                "ln2": _norm_specs(cfg), "mlp": _mlp_specs(cfg)}
    raise NotImplementedError(
        f"block kind {kind!r} is not ported yet (ROADMAP Queue 1, item 4c)")


def _stack(tree, n: int):
    if isinstance(tree, ParamSpec):
        return ParamSpec((n,) + tree.shape, tree.init, tree.scale)
    return {k: _stack(v, n) for k, v in tree.items()}


def model_specs(cfg: ArchConfig) -> Dict:
    """Full parameter tree spec, laid out as the reference's: one stack of
    the ``"attn"`` block under ``groups["b0_attn"]`` (leading axis =
    layer; the dense pattern has one block, so no remainder layers)."""
    D, V = cfg.d_model, cfg.vocab
    specs: Dict = {"embed": {"tok": ParamSpec((V, D))},
                   "final_norm": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["unembed"] = {"w": ParamSpec((D, V))}
    specs["groups"] = {f"b{i}_{k}": _stack(block_specs(cfg, k), cfg.n_groups)
                       for i, k in enumerate(cfg.pattern)}
    return specs


def count_params(specs) -> int:
    if isinstance(specs, ParamSpec):
        return math.prod(specs.shape)
    return sum(count_params(v) for v in specs.values())


def param_tree(specs: Dict, device: torch.device) -> nn.Module:
    """Uninitialised fp32 parameters for a spec tree: a ``ParameterDict``
    for a dict of specs, a ``ModuleDict`` of those for a dict of dicts.
    Each parameter keeps its spec as ``.spec`` (read by :func:`init_`)."""
    if all(isinstance(v, ParamSpec) for v in specs.values()):
        out = nn.ParameterDict()
        for name, s in specs.items():
            p = nn.Parameter(torch.empty(s.shape, dtype=torch.float32,
                                         device=device))
            p.spec = s
            out[name] = p
        return out
    return nn.ModuleDict({k: param_tree(v, device) for k, v in specs.items()})


@torch.no_grad()
def init_(p: nn.Parameter, generator: torch.Generator) -> None:
    """Fill ``p`` in place from its spec: normal(0, scale), ones or zeros."""
    s = p.spec
    if s.init == "zeros":
        p.zero_()
    elif s.init == "ones":
        p.fill_(1.0)
    elif s.init == "normal":
        p.normal_(0.0, s.scale, generator=generator)
    else:
        raise ValueError(f"init {s.init!r}")
