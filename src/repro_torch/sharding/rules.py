"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

The counterpart of the reference's ``repro/sharding/rules.py``: the same
rule tables, and :func:`partition_spec` / :func:`batch_spec` as plain
functions over a mesh *shape*, an ordered ``{axis name: size}`` mapping
(the reference reads only a ``Mesh``'s ``axis_names`` and ``shape``),
returning a tuple where the reference returns a ``PartitionSpec`` (an
entry is None, an axis name or a tuple of them).  A spec becomes
DTensor placements on a ``DeviceMesh`` whose dimensions are named
(:func:`placements`, :class:`NamedSharding`): the train state and batch
of a step over a mesh (``train/train_step.py``) and the memory dry-run
(``launch/dryrun.py``) are placed by these rules.

Every parameter leaf carries logical axis names; the rules map them to
mesh axes.  A mapping is applied only when the mesh axes exist *and* the
dimension is divisible by their total size — otherwise the dimension is
replicated (e.g. whisper's 6 heads or vocab 51865 on a 16-way model
axis).  This keeps a single rule set valid for every architecture on
every mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

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


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's order, of a mesh shape (returned
    as it is) or of a ``DeviceMesh`` (from its ``mesh_dim_names``)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh's dimensions have no names")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


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
    mesh = mesh_shape(mesh)
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
    mesh = mesh_shape(mesh)
    axes = _mesh_axes(mesh, ("pod", "data"))
    return (axes if len(axes) > 1 else (axes[0] if axes else None),)


def batch_sharding(mesh: MeshShape, batch_size: int) -> Spec:
    """The spec of a batch of ``batch_size`` rows: split over the data
    (and pod) axes when they divide it, else replicated (``()``, as the
    reference's ``P()``: e.g. a batch of 1 on a data axis of 4)."""
    mesh = mesh_shape(mesh)
    axes = _mesh_axes(mesh, ("pod", "data"))
    total = math.prod(mesh[a] for a in axes)
    if axes and batch_size % total == 0:
        return (axes if len(axes) > 1 else axes[0],)
    return ()


def target_axes(target: AxisTarget) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (``()`` for None)."""
    if target is None:
        return ()
    return (target,) if isinstance(target, str) else tuple(target)


def placements(spec: Spec, mesh) -> List:
    """A partition spec as DTensor placements, one a mesh dimension in the
    mesh's order: ``Shard(d)`` on each mesh dimension that tensor
    dimension d is split over (a tuple of axes, such as ``embed`` ->
    ``("pod", "data")`` under FSDP_RULES, gives a ``Shard(d)`` on each,
    the first the outermost), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))
    out: List = [Replicate()] * len(names)
    for dim, target in enumerate(spec):
        for axis in target_axes(target):
            out[names.index(axis)] = Shard(dim)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A tensor's place on a mesh: the reference's ``NamedSharding``, with
    the partition spec (``spec``) and its DTensor ``placements``.
    ``mesh`` is a ``DeviceMesh`` or a mesh shape."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> List:
        return placements(self.spec, self.mesh)


def named_sharding(mesh, logical: Sequence[Optional[str]],
                   shape: Sequence[int],
                   rules: Optional[Dict[str, AxisTarget]] = None,
                   ) -> NamedSharding:
    return NamedSharding(mesh, partition_spec(logical, shape, mesh, rules))


def tree_shardings(mesh, logical_tree, shape_tree,
                   rules: Optional[Dict[str, AxisTarget]] = None):
    """Shardings for a nested dict of logical axes and one of shapes (each
    leaf a shape or anything with ``.shape``), keyed alike."""
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v, shape_tree[k], rules)
                for k, v in logical_tree.items()}
    shape = getattr(shape_tree, "shape", shape_tree)
    return named_sharding(mesh, logical_tree, shape, rules)


def batch_named_sharding(mesh, shape: Sequence[int]) -> NamedSharding:
    """The sharding of a batch entry of ``shape``: its leading dimension
    as :func:`batch_sharding` says, the others replicated."""
    spec = batch_sharding(mesh, shape[0])
    return NamedSharding(mesh, spec + (None,) * (len(shape) - len(spec)))


def constrain_batch(x, mesh):
    """The activation constraint: ``x`` with its leading batch dimension
    split over the data (and pod) axes, replicated when they do not
    divide it.  A DTensor is redistributed; a plain tensor, which every
    rank holds whole, is sliced to this rank's shard (no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    place = batch_named_sharding(mesh, x.shape).placements
    if isinstance(x, DTensor):
        return x.redistribute(mesh, place)
    return distribute_tensor(x, mesh, place, src_data_rank=None)


def place(t, sharding: NamedSharding, dtype=None):
    """``t``, which every rank holds whole (or a meta-device stand-in),
    as a DTensor placed by ``sharding`` on its
    ``DeviceMesh``: each rank keeps a copy of its own shard, in ``dtype``
    (``t``'s by default), on the mesh's device, and nothing is
    communicated.  The shard owns its storage, so ``t`` can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh, where = sharding.mesh, sharding.placements
    d = distribute_tensor(t.detach(), mesh, where, src_data_rank=None)
    local = d.to_local().to(dtype or t.dtype, copy=True)
    return DTensor.from_local(local, mesh, where, run_check=False,
                              shape=d.shape, stride=d.stride())
