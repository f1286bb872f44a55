"""Parameter specifications: shapes and init per architecture.

The counterpart of the reference's ``repro/models/specs.py``, every
block kind of its ``block_specs`` (``:106-132``): ``attn``/``local``,
``moe``, ``cross`` (with its ``gate``), ``rglru``, ``rwkv``, ``enc`` and
``dec``, the layernorm's bias and the gelu MLP's ``bi``/``bo``, and the
model's ``img_proj`` and ``encoder`` subtrees (``:142-165``).  The
parameter tree is described as data (``ParamSpec`` leaves, the
reference's tree, names and logical sharding axes, which
``sharding/rules.py`` turns into placements on a mesh), so the
parameter count, the shapes and the placements need no allocation;
:func:`param_tree` turns a block's or a model's top-level specs into
modules of fp32 parameters, and :func:`init_` fills one from a
``torch.Generator``: normal(0, scale), ones, zeros, or ``"lru"``
(uniform on [-8, -4)), as the reference's init (its numbers differ: a
``torch.Generator`` is not a JAX key).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig


Logical = Tuple[Optional[str], ...]


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, nothing allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Logical
    init: str = "normal"      # normal | zeros | ones | lru
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _norm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d = {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return d


def _attn_specs(cfg: ArchConfig, cross: bool = False
                ) -> Dict[str, ParamSpec]:
    """Attention projections; a cross attention of an encoder-decoder
    has ``n_heads`` KV heads."""
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    kvh = H if cross and cfg.encoder_decoder else Hkv
    s = {
        "wq": ParamSpec((D, H, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, kvh, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, kvh, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, dh, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, dh), ("heads", "head_dim"), "zeros")
        s["bk"] = ParamSpec((kvh, dh), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamSpec((kvh, dh), ("kv_heads", "head_dim"), "zeros")
    return s


def _mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, F = cfg.d_model, cfg.d_ff
    s = {"wi": ParamSpec((D, F), ("embed", "mlp")),
         "wo": ParamSpec((F, D), ("mlp", "embed"))}
    if cfg.act == "silu":
        s["wg"] = ParamSpec((D, F), ("embed", "mlp"))
    else:  # gelu with biases (whisper-style)
        s["bi"] = ParamSpec((F,), ("mlp",), "zeros")
        s["bo"] = ParamSpec((D,), ("embed",), "zeros")
    return s


def _moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((D, E), ("embed", "expert")),
        "wi": ParamSpec((E, D, Fe), ("expert", "embed", "mlp")),
        "wg": ParamSpec((E, D, Fe), ("expert", "embed", "mlp")),
        "wo": ParamSpec((E, Fe, D), ("expert", "mlp", "embed")),
    }


def _rglru_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, R, CW = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width
    return {
        "wx": ParamSpec((D, R), ("embed", "rnn")),
        "wy": ParamSpec((D, R), ("embed", "rnn")),
        "conv_w": ParamSpec((CW, R), ("conv", "rnn")),
        "conv_b": ParamSpec((R,), ("rnn",), "zeros"),
        "lam": ParamSpec((R,), ("rnn",), "lru"),
        "wa": ParamSpec((R, R), ("rnn_in", "rnn")),
        "wi": ParamSpec((R, R), ("rnn_in", "rnn")),
        "wout": ParamSpec((R, D), ("rnn", "embed")),
    }


def _rwkv_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    D, F = cfg.d_model, cfg.d_ff
    s: Dict[str, ParamSpec] = {}
    for mu in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        s[mu] = ParamSpec((D,), ("embed",), "zeros")
    for w in ("wr", "wk", "wv", "wg"):
        s[w] = ParamSpec((D, D), ("embed", "rnn"))
    s["ww"] = ParamSpec((D, D), ("embed", "rnn"), scale=0.002)
    s["w_bias"] = ParamSpec((D,), ("rnn",), "lru")
    s["u"] = ParamSpec((D,), ("rnn",), "zeros")
    s["wo"] = ParamSpec((D, D), ("rnn", "embed"))
    s["gn_scale"] = ParamSpec((D,), ("rnn",), "ones")
    # channel mix
    s["c_mu_k"] = ParamSpec((D,), ("embed",), "zeros")
    s["c_mu_r"] = ParamSpec((D,), ("embed",), "zeros")
    s["c_wk"] = ParamSpec((D, F), ("embed", "mlp"))
    s["c_wv"] = ParamSpec((F, D), ("mlp", "embed"))
    s["c_wr"] = ParamSpec((D, D), ("embed", "rnn"))
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
                "gate": ParamSpec((1,), (None,), "zeros"),
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
        return ParamSpec((n,) + tree.shape, ("layers",) + tree.logical,
                         tree.init, tree.scale)
    return {k: _stack(v, n) for k, v in tree.items()}


def model_specs(cfg: ArchConfig) -> Dict:
    """Full parameter tree spec, laid out as the reference's: the layers
    of the repeated pattern stacked per pattern entry under
    ``groups["b<j>_<kind>"]`` (leading axis = group, logical axis
    ``"layers"``), the remainder layers under ``rem["r<j>_<kind>"]``,
    then ``img_proj`` (VLM) and the ``encoder`` (encoder-decoder)."""
    D, V = cfg.d_model, cfg.vocab
    specs: Dict = {"embed": {"tok": ParamSpec((V, D), ("vocab", "embed"))},
                   "final_norm": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["unembed"] = {"w": ParamSpec((D, V), ("embed", "vocab"))}
    pat = cfg.pattern
    if cfg.n_groups > 0:
        specs["groups"] = {f"b{i}_{k}": _stack(block_specs(cfg, k),
                                               cfg.n_groups)
                           for i, k in enumerate(pat)}
    if cfg.n_rem_layers:
        specs["rem"] = {f"r{i}_{k}": block_specs(cfg, k)
                        for i, k in enumerate(pat[: cfg.n_rem_layers])}
    if cfg.family == "vlm":
        specs["img_proj"] = {"w": ParamSpec((D, D), ("embed", "embed_out"))}
    if cfg.encoder_decoder:
        specs["encoder"] = {
            "groups": {"b0_enc": _stack(block_specs(cfg, "enc"),
                                        cfg.n_encoder_layers)},
            "final_norm": _norm_specs(cfg),
            "in_proj": {"w": ParamSpec((D, D), ("embed", "embed_out"))},
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


def at_use(p):
    """A parameter as the model's code reads it.  Over a mesh a DTensor
    split over the data (or pod) axes, a ZeRO-3 placement, is gathered
    over them first (the model axis keeps its split): the FSDP
    all-gather at use, whose backward reduce-scatters the gradient, and
    which a remat'd layer repeats in its recompute.  Anything else is
    returned as it is."""
    if not hasattr(p, "device_mesh"):
        return p
    from torch.distributed.tensor import Replicate
    names = p.device_mesh.mesh_dim_names
    want = [Replicate() if n in ("pod", "data") else where
            for n, where in zip(names, p.placements)]
    if want == list(p.placements):
        return p
    return p.redistribute(p.device_mesh, want)


class Params(nn.ParameterDict):
    """A dict of parameters whose ``tree[name]`` is :func:`at_use` of the
    parameter (``_parameters[name]`` is the parameter itself)."""

    def __getitem__(self, key: str):
        return at_use(super().__getitem__(key))


class Block(nn.ModuleDict):
    """A subtree that holds both parameters and subtrees (the ``cross``
    block's ``gate`` beside its ``xattn``, ...): ``tree[name]`` gives
    either (a parameter through :func:`at_use`), and the state dict
    names them ``<prefix>.<name>`` as the reference's tree does."""

    def __getitem__(self, key: str):
        if key in self._parameters:
            return at_use(self._parameters[key])
        return super().__getitem__(key)


def _param(s: ParamSpec, device: torch.device) -> nn.Parameter:
    p = nn.Parameter(torch.empty(s.shape, dtype=torch.float32,
                                 device=device))
    p.spec = s
    return p


def param_tree(specs: Dict, device: torch.device) -> nn.Module:
    """Uninitialised fp32 parameters for a spec tree: a :class:`Params`
    for a dict of specs, a ``ModuleDict`` for a dict of dicts, a
    :class:`Block` for a dict of both.  Each parameter keeps its spec as
    ``.spec`` (read by :func:`init_`)."""
    leaves = {k: v for k, v in specs.items() if isinstance(v, ParamSpec)}
    if len(leaves) == len(specs):
        return Params({k: _param(s, device) for k, s in leaves.items()})
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
