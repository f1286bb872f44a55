"""Parameter specifications: shapes and init per architecture.

The counterpart of the reference's ``repro/models/specs.py``, every
block kind of its ``block_specs`` (``:106-132``): ``attn``/``local``,
``moe``, ``cross`` (with its ``gate``), ``rglru``, ``rwkv``, ``enc`` and
``dec``, the layernorm's bias and the gelu MLP's ``bi``/``bo``, and the
model's ``img_proj`` and ``encoder`` subtrees (``:142-165``).  The
parameter tree is described as data (``ParamSpec`` leaves, the
reference's tree and names, without its sharding axes, which the port
does not use), so the parameter count needs no allocation;
:func:`param_tree` turns a block's or a model's top-level specs into
modules of fp32 parameters, and :func:`init_` fills one from a
``torch.Generator``: normal(0, scale), ones, zeros, or ``"lru"``
(uniform on [-8, -4)), as the reference's init (its numbers differ: a
``torch.Generator`` is not a JAX key).
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
    init: str = "normal"      # normal | zeros | ones | lru
    scale: float = 0.02


def _norm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = {"scale": ParamSpec((cfg.d_model,), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamSpec((cfg.d_model,), "zeros")
    return d


def _attn_specs(cfg: ArchConfig, cross: bool = False
                ) -> Dict[str, ParamSpec]:
    """Attention projections; a cross attention of an encoder-decoder
    has ``n_heads`` KV heads."""
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    kvh = H if cross and cfg.encoder_decoder else Hkv
    s = {"wq": ParamSpec((D, H, dh)), "wk": ParamSpec((D, kvh, dh)),
         "wv": ParamSpec((D, kvh, dh)), "wo": ParamSpec((H, dh, D))}
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, dh), "zeros")
        s["bk"] = ParamSpec((kvh, dh), "zeros")
        s["bv"] = ParamSpec((kvh, dh), "zeros")
    return s


def _mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, F = cfg.d_model, cfg.d_ff
    s = {"wi": ParamSpec((D, F)), "wo": ParamSpec((F, D))}
    if cfg.act == "silu":
        s["wg"] = ParamSpec((D, F))
    else:  # gelu with biases (whisper-style)
        s["bi"] = ParamSpec((F,), "zeros")
        s["bo"] = ParamSpec((D,), "zeros")
    return s


def _moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": ParamSpec((D, E)), "wi": ParamSpec((E, D, Fe)),
            "wg": ParamSpec((E, D, Fe)), "wo": ParamSpec((E, Fe, D))}


def _rglru_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, R, CW = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width
    return {"wx": ParamSpec((D, R)), "wy": ParamSpec((D, R)),
            "conv_w": ParamSpec((CW, R)), "conv_b": ParamSpec((R,), "zeros"),
            "lam": ParamSpec((R,), "lru"), "wa": ParamSpec((R, R)),
            "wi": ParamSpec((R, R)), "wout": ParamSpec((R, D))}


def _rwkv_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, F = cfg.d_model, cfg.d_ff
    s: Dict[str, ParamSpec] = {}
    for mu in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        s[mu] = ParamSpec((D,), "zeros")
    for w in ("wr", "wk", "wv", "wg"):
        s[w] = ParamSpec((D, D))
    s["ww"] = ParamSpec((D, D), scale=0.002)
    s["w_bias"] = ParamSpec((D,), "lru")
    s["u"] = ParamSpec((D,), "zeros")
    s["wo"] = ParamSpec((D, D))
    s["gn_scale"] = ParamSpec((D,), "ones")
    # channel mix
    s["c_mu_k"] = ParamSpec((D,), "zeros")
    s["c_mu_r"] = ParamSpec((D,), "zeros")
    s["c_wk"] = ParamSpec((D, F))
    s["c_wv"] = ParamSpec((F, D))
    s["c_wr"] = ParamSpec((D, D))
    return s


def block_specs(cfg: ArchConfig, kind: str) -> Dict:
    """Specs of one transformer block of the given kind."""
    if kind in ("attn", "local", "enc"):
        return {"ln1": _norm_specs(cfg), "attn": _attn_specs(cfg),
                "ln2": _norm_specs(cfg), "mlp": _mlp_specs(cfg)}
    if kind == "moe":
        return {"ln1": _norm_specs(cfg), "attn": _attn_specs(cfg),
                "ln2": _norm_specs(cfg), "moe": _moe_specs(cfg)}
    if kind == "cross":
        return {"ln1": _norm_specs(cfg), "xattn": _attn_specs(cfg, cross=True),
                "gate": ParamSpec((1,), "zeros"),
                "ln2": _norm_specs(cfg), "mlp": _mlp_specs(cfg)}
    if kind == "rglru":
        return {"ln1": _norm_specs(cfg), "rec": _rglru_specs(cfg),
                "ln2": _norm_specs(cfg), "mlp": _mlp_specs(cfg)}
    if kind == "rwkv":
        return {"ln1": _norm_specs(cfg), "ln2": _norm_specs(cfg),
                "mix": _rwkv_specs(cfg)}
    if kind == "dec":
        return {"ln1": _norm_specs(cfg), "attn": _attn_specs(cfg),
                "lnx": _norm_specs(cfg), "xattn": _attn_specs(cfg, cross=True),
                "ln2": _norm_specs(cfg), "mlp": _mlp_specs(cfg)}
    raise ValueError(kind)


def _stack(tree, n: int):
    if isinstance(tree, ParamSpec):
        return ParamSpec((n,) + tree.shape, tree.init, tree.scale)
    return {k: _stack(v, n) for k, v in tree.items()}


def model_specs(cfg: ArchConfig) -> Dict:
    """Full parameter tree spec, laid out as the reference's: the layers
    of the repeated pattern stacked per pattern entry under
    ``groups["b<j>_<kind>"]`` (leading axis = group), the remainder
    layers under ``rem["r<j>_<kind>"]``, then ``img_proj`` (VLM) and the
    ``encoder`` (encoder-decoder)."""
    D, V = cfg.d_model, cfg.vocab
    specs: Dict = {"embed": {"tok": ParamSpec((V, D))},
                   "final_norm": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["unembed"] = {"w": ParamSpec((D, V))}
    pat = cfg.pattern
    if cfg.n_groups > 0:
        specs["groups"] = {f"b{i}_{k}": _stack(block_specs(cfg, k),
                                               cfg.n_groups)
                           for i, k in enumerate(pat)}
    if cfg.n_rem_layers:
        specs["rem"] = {f"r{i}_{k}": block_specs(cfg, k)
                        for i, k in enumerate(pat[: cfg.n_rem_layers])}
    if cfg.family == "vlm":
        specs["img_proj"] = {"w": ParamSpec((D, D))}
    if cfg.encoder_decoder:
        specs["encoder"] = {
            "groups": {"b0_enc": _stack(block_specs(cfg, "enc"),
                                        cfg.n_encoder_layers)},
            "final_norm": _norm_specs(cfg),
            "in_proj": {"w": ParamSpec((D, D))},
        }
    return specs


def count_params(specs) -> int:
    if isinstance(specs, ParamSpec):
        return math.prod(specs.shape)
    return sum(count_params(v) for v in specs.values())


def expert_params(cfg: ArchConfig) -> Tuple[int, int]:
    """(total expert params over all moe layers, per-expert-per-layer)."""
    per = 3 * cfg.d_model * cfg.d_ff
    n_moe = sum(1 for k in cfg.layer_kinds() if k == "moe")
    return per * cfg.n_experts * n_moe, per


class Block(nn.ModuleDict):
    """A subtree that holds both parameters and subtrees (the ``cross``
    block's ``gate`` beside its ``xattn``, ...): ``tree[name]`` gives
    either, and the state dict names them ``<prefix>.<name>`` as the
    reference's tree does."""

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)


def _param(s: ParamSpec, device: torch.device) -> nn.Parameter:
    p = nn.Parameter(torch.empty(s.shape, dtype=torch.float32,
                                 device=device))
    p.spec = s
    return p


def param_tree(specs: Dict, device: torch.device) -> nn.Module:
    """Uninitialised fp32 parameters for a spec tree: a ``ParameterDict``
    for a dict of specs, a ``ModuleDict`` for a dict of dicts, a
    :class:`Block` for a dict of both.  Each parameter keeps its spec as
    ``.spec`` (read by :func:`init_`)."""
    leaves = {k: v for k, v in specs.items() if isinstance(v, ParamSpec)}
    if len(leaves) == len(specs):
        return nn.ParameterDict({k: _param(s, device)
                                 for k, s in leaves.items()})
    subtrees = {k: param_tree(v, device) for k, v in specs.items()
                if k not in leaves}
    if not leaves:
        return nn.ModuleDict(subtrees)
    out = Block(subtrees)
    for k, s in leaves.items():
        out.register_parameter(k, _param(s, device))
    return out


@torch.no_grad()
def init_(p: nn.Parameter, generator: torch.Generator) -> None:
    """Fill ``p`` in place from its spec: normal(0, scale), ones, zeros,
    or uniform on [-8, -4) (``"lru"``: an RG-LRU decay that starts in
    about [0.9, 0.999])."""
    s = p.spec
    if s.init == "zeros":
        p.zero_()
    elif s.init == "ones":
        p.fill_(1.0)
    elif s.init == "normal":
        p.normal_(0.0, s.scale, generator=generator)
    elif s.init == "lru":
        p.uniform_(-8.0, -4.0, generator=generator)
    else:
        raise ValueError(f"init {s.init!r}")
