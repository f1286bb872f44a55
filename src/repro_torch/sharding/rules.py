"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

The counterpart of the reference's ``repro/sharding/rules.py``: the same
rule tables, and :func:`partition_spec` / :func:`batch_spec` as plain
functions over a mesh *shape*, an ordered ``{axis name: size}`` mapping
(the reference reads only a ``Mesh``'s ``axis_names`` and ``shape``),
returning a tuple where the reference returns a ``PartitionSpec`` (an
entry is None, an axis name or a tuple of them).  Nothing here makes a
mesh or places a tensor: the multi-card slice (ROADMAP Queue 1, item 4e)
and the dry-run (item 4d) read these rules.

Every parameter leaf carries logical axis names; the rules map them to
mesh axes.  A mapping is applied only when the mesh axes exist *and* the
dimension is divisible by their total size — otherwise the dimension is
replicated (e.g. whisper's 6 heads or vocab 51865 on a 16-way model
axis).  This keeps a single rule set valid for every architecture on
every mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

AxisTarget = Union[None, str, Tuple[str, ...]]
MeshShape = Mapping[str, int]
Spec = Tuple[AxisTarget, ...]

# parameter logical axis -> mesh axes
DEFAULT_RULES: Dict[str, AxisTarget] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "rnn": "model",
    "embed": None,
    "embed_out": None,
    "head_dim": None,
    "layers": None,
    "conv": None,
    "rnn_in": None,
}

# activation logical axis -> mesh axes
ACT_RULES: Dict[str, AxisTarget] = {
    "batch": ("pod", "data"),
    "seq": None,                # sequence parallelism is a perf-pass option
    "kv_seq": "model",          # decode caches: shard the cache depth over
                                # model (kv_heads <= 8 never divide 16)
    "act_embed": None,
    "act_heads": "model",
    "act_kv": "model",
    "act_vocab": "model",
    "img": None,
}

# ZeRO-3/FSDP training rules: weights & optimizer states additionally shard
# their 'embed'-like dims over the data(+pod) axes.
FSDP_RULES = dict(DEFAULT_RULES,
                  embed=("pod", "data"),
                  rnn_in=("pod", "data"),
                  embed_out="model")

# Output-dim MoE ZeRO-3: shard expert FFN width (mlp) over data instead of
# the contracting embed dim.
MOE_FSDP_OUTDIM = dict(DEFAULT_RULES, mlp=("pod", "data"))

# Expert-data serving rules: shard the expert axis over 'data' instead of
# ZeRO-gathering weights — tokens travel (all-to-all), weights stay
# resident.
MOE_SERVE_RULES = dict(DEFAULT_RULES, expert=("pod", "data"))


def _mesh_axes(mesh: MeshShape, target: AxisTarget) -> Tuple[str, ...]:
    if target is None:
        return ()
    axes = (target,) if isinstance(target, str) else tuple(target)
    return tuple(a for a in axes if a in mesh)


def partition_spec(logical: Sequence[Optional[str]],
                   shape: Sequence[int], mesh: MeshShape,
                   rules: Optional[Dict[str, AxisTarget]] = None) -> Spec:
    """The mesh axes each dimension of a ``shape`` tensor with these
    logical axis names is split over (None: replicated)."""
    rules = {**DEFAULT_RULES, **ACT_RULES, **(rules or {})}
    used: set = set()
    parts = []
    for dim, name in zip(shape, logical):
        target: AxisTarget = rules.get(name) if name else None
        axes = _mesh_axes(mesh, target) if target is not None else ()
        axes = tuple(a for a in axes if a not in used)
        total = math.prod(mesh[a] for a in axes)
        if axes and dim % total == 0 and total > 1:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        else:
            parts.append(None)
    return tuple(parts)


def batch_spec(mesh: MeshShape) -> Spec:
    """The leading batch dimension's split over the data (and pod) axes."""
    axes = _mesh_axes(mesh, ("pod", "data"))
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


def batch_sharding(mesh: MeshShape, batch_size: int) -> Spec:
    """The spec of a batch of ``batch_size`` rows: split over the data
    (and pod) axes when they divide it, else replicated (``()``, as the
    reference's ``P()``: e.g. a batch of 1 on a data axis of 4)."""
    axes = _mesh_axes(mesh, ("pod", "data"))
    total = math.prod(mesh[a] for a in axes)
    if axes and batch_size % total == 0:
        return (axes if len(axes) > 1 else axes[0],)
    return ()
