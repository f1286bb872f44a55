"""Carry the reference's state across to the port.

The join has no weights: its state is the database, the query and the
plan.  :func:`from_reference` rebuilds the port's objects from plain
Python and numpy values that the reference's objects expose (relations,
atoms, TD bags and parents, variable order), so both engines can run the
same plan and a difference in planning cannot hide a difference in
execution.  :func:`table_from_reference` carries a warm tier-2 table
across: the state a reference table exports as numpy arrays becomes a
port :class:`~.core.cache.DeviceCache` through its ``import_state``, so
a warm pass can be compared with the reference's warm pass from the same
tables (the port's ``export_state`` gives the same layout back, which the
reference's ``import_state`` takes).  :func:`static_tables_from_reference`
does the same for the static executor's tables (tuples of planes), so a
warm static pass of the port can start from the reference's cold-pass
tables.  :func:`engine_config_from_reference` maps a reference
``JoinEngineConfig`` onto the port's.

The LM has weights, random ones (nothing is fetched): the reference's
parameter tree, as numpy arrays, becomes the port's ``state_dict``
(:func:`lm_params_from_reference`), and a reference ``ArchConfig``'s
fields the port's (:func:`arch_config_from_reference`);
:data:`ATTENTION_IMPLS` maps the reference's attention ``impl`` names.
A reference train state (parameters and AdamW's ``m``, ``v`` and
``step``) becomes the port's through the same layout code
(:func:`train_state_from_reference`).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.cache import CacheConfig, DeviceCache
from .core.cq import CQ, Atom
from .core.db import Database
from .core.frontier import resolve_device
from .core.td import TreeDecomposition

# dtypes of a static table tuple's planes, in order: keys, vals, used,
# stamp, cost, then with payloads pay_off, pay_len, slab and bump
_STATIC_DTYPES = (torch.int64, torch.int64, torch.bool, torch.int32,
                  torch.int64, torch.int32, torch.int32, torch.int32,
                  torch.int32)

__all__ = ["from_reference", "table_from_reference",
           "static_tables_from_reference", "engine_config_from_reference",
           "arch_config_from_reference", "lm_params_from_reference",
           "ATTENTION_IMPLS"]

# the reference's kernel-path names, mapped onto the port's
_IMPLS = {"bsearch": "bsearch", "pallas": "leapfrog"}
# expand_kernel / fold_kernel / emit_kernel
_KERNEL_PATHS = {"auto": "fused", "pallas": "fused", "xla": "chain"}
_KERNEL_KNOBS = ("expand_kernel", "fold_kernel", "emit_kernel")
ATTENTION_IMPLS = {"pallas": "fused", "xla": "chain", "ref": "ref"}


def from_reference(relations: Dict[str, np.ndarray],
                   atoms: Sequence[Tuple[str, Tuple[str, ...]]],
                   bags: Sequence[FrozenSet[str]], parent: Sequence[int],
                   order: Sequence[str],
                   children: Optional[Sequence[Sequence[int]]] = None,
                   ) -> Tuple[Database, CQ, TreeDecomposition,
                              Tuple[str, ...]]:
    """The port's ``(Database, CQ, TreeDecomposition, order)``.

    ``relations`` maps names to ``(N, k)`` integer arrays, ``atoms`` lists
    ``(relation, variables)`` pairs in query order, ``bags``/``parent``
    describe the TD (``parent[root] == -1``) and ``children``, when given,
    keeps the reference's child order (by default children follow node
    index order)."""
    db = Database({name: np.asarray(rows, dtype=np.int64)
                   for name, rows in relations.items()})
    q = CQ(tuple(Atom(rel, tuple(vs)) for rel, vs in atoms))
    kids: List[List[int]] = ([] if children is None
                             else [list(c) for c in children])
    td = TreeDecomposition([frozenset(b) for b in bags],
                           [int(p) for p in parent], kids)
    return db, q, td, tuple(order)


def table_from_reference(state: Dict[str, object], config: CacheConfig,
                         device="cuda") -> DeviceCache:
    """A port tier-2 table holding a reference table's exported state.

    ``state`` is what the reference's ``DeviceCache.export_state()``
    returns: the ``keys``/``vals``/``used``/``stamp``/``cost`` planes, and
    with payloads the ``pay_off``/``pay_len`` planes, the ``slab`` (when
    the arena was allocated), ``slab_bump``, ``payload_flushes`` and the
    LRU ``tick``.  A fresh table on ``device`` (the card unless the caller
    asks for the CPU) adopts it with ``DeviceCache.import_state``.  Raises
    ``ValueError`` unless that returns ``"ok"``: on planes that do not fit
    ``config``, or a slab epoch the payloads cannot be served from."""
    tbl = DeviceCache.create(config, device=resolve_device(device))
    status = tbl.import_state(state)
    if status != "ok":
        raise ValueError(f"the table state was not adopted: {status}")
    return tbl


def static_tables_from_reference(tables: Dict[int, Sequence[object]],
                                 device="cuda") -> Dict[int, tuple]:
    """The port's static tables from a reference ``StaticCLFTJ`` tables
    dict (node id to a tuple of planes, given as numpy arrays): the
    count-only 5-tuple ``(keys, vals, used, stamp, cost)`` or the 9-tuple
    adding ``(pay_off, pay_len, slab, bump)``, each plane a tensor of the
    reference's dtype on ``device`` (the card unless the caller asks for
    the CPU).  Raises ``ValueError`` on a tuple of another length or
    planes of mismatched shapes."""
    dev = resolve_device(device)
    out: Dict[int, tuple] = {}
    for node, tbl in tables.items():
        if len(tbl) not in (5, 9):
            raise ValueError(f"table {node}: {len(tbl)} planes, expected "
                             f"5 or 9")
        planes = tuple(torch.from_numpy(np.array(a)).to(dev, dt)
                       for a, dt in zip(tbl, _STATIC_DTYPES))
        shape = planes[0].shape
        if any(x.shape != shape for x in planes[1:min(len(planes), 7)]):
            raise ValueError(f"table {node}: planes of unequal shape")
        if len(planes) == 9 and planes[8].dim() != 0:
            raise ValueError(f"table {node}: bump must be a scalar")
        out[int(node)] = planes
    return out


def engine_config_from_reference(cfg):
    """The port's :class:`~.configs.paper_clftj.JoinEngineConfig` for a
    reference ``JoinEngineConfig``: ``impl`` ``"pallas"`` becomes
    ``"leapfrog"``; each of ``expand_kernel``, ``fold_kernel`` and
    ``emit_kernel`` of ``"auto"``/``"pallas"`` becomes ``"fused"`` and of
    ``"xla"`` ``"chain"``; every other field, the host engine's included,
    is copied.  Raises ``ValueError`` on an ``impl`` or kernel path the
    reference does not name."""
    from .configs.paper_clftj import JoinEngineConfig
    knobs = {k: getattr(cfg, k) for k in _KERNEL_KNOBS}
    if cfg.impl not in _IMPLS or not set(knobs.values()) <= set(
            _KERNEL_PATHS):
        raise ValueError(f"no port path for impl={cfg.impl!r}, {knobs}")
    fields = {f: getattr(cfg, f)
              for f in JoinEngineConfig.__dataclass_fields__}
    fields.update(impl=_IMPLS[cfg.impl],
                  **{k: _KERNEL_PATHS[v] for k, v in knobs.items()})
    return JoinEngineConfig(**fields)


def arch_config_from_reference(fields: Dict[str, object]):
    """The port's :class:`~.configs.base.ArchConfig` with a reference
    config's fields (``dataclasses.asdict`` of it); both have the same
    fields, and an unknown one raises ``TypeError``."""
    from .configs.base import ArchConfig
    return ArchConfig(**fields)


def lm_params_from_reference(cfg, params: Dict) -> Dict[str, torch.Tensor]:
    """The port's ``Model`` state dict from the reference's parameter tree
    (nested dicts of numpy arrays, as ``Model.init`` gives them).  Each
    weight keeps its layout (``wq`` (D, H, Dh), ...), so both packages
    compute the same einsums.  The reference stacks the layers of its
    repeated pattern per pattern entry: layer ``g·len(pattern) + j`` is
    entry ``g`` of ``groups["b<j>_<kind>"]``, and the remainder layers
    after them are ``rem["r<j>_<kind>"]``; all of them become
    ``blocks.<layer>``.  ``img_proj`` keeps its name, and the encoder's
    stack ``encoder.groups.b0_enc`` becomes ``encoder.blocks.<i>`` beside
    ``encoder.final_norm`` and ``encoder.in_proj``.  Tensors are fp32 on
    the CPU (``load_state_dict`` copies them to the model's device)."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def flat(prefix: str, tree: Dict, index=None):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                yield from flat(f"{prefix}{name}.", leaf, index)
            else:
                yield f"{prefix}{name}", t(leaf if index is None
                                           else np.asarray(leaf)[index])

    sd = {}
    for top in ("embed", "final_norm", "unembed", "img_proj"):
        if top in params:
            sd.update(flat(f"{top}.", params[top]))
    pat = cfg.pattern
    for g in range(cfg.n_groups):
        for j, kind in enumerate(pat):
            sd.update(flat(f"blocks.{g * len(pat) + j}.",
                           params["groups"][f"b{j}_{kind}"], g))
    for j, kind in enumerate(pat[: cfg.n_rem_layers]):
        sd.update(flat(f"blocks.{cfg.n_groups * len(pat) + j}.",
                       params["rem"][f"r{j}_{kind}"]))
    if "encoder" in params:
        enc = params["encoder"]
        for i in range(cfg.n_encoder_layers):
            sd.update(flat(f"encoder.blocks.{i}.", enc["groups"]["b0_enc"],
                           i))
        sd.update(flat("encoder.final_norm.", enc["final_norm"]))
        sd.update(flat("encoder.in_proj.", enc["in_proj"]))
    return sd


def train_state_from_reference(cfg, state: Dict) -> Dict:
    """The port's train state (``train/train_step.py``) from the
    reference's, ``{"params": tree, "opt": {"m": tree, "v": tree,
    "step": scalar}}`` as numpy (``jax.tree.map(np.asarray, state)``, or
    a reference checkpoint restored): ``params``, ``m`` and ``v`` laid out
    by :func:`lm_params_from_reference` (fp32 state-dict names, stacked
    groups unstacked), ``step`` an int32 scalar; all on the CPU."""
    opt = state["opt"]
    return {"params": lm_params_from_reference(cfg, state["params"]),
            "opt": {"m": lm_params_from_reference(cfg, opt["m"]),
                    "v": lm_params_from_reference(cfg, opt["v"]),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32)}}
