"""Elastic re-scaling: restore a checkpoint under a different mesh.

The counterpart of the reference's ``repro/runtime/elastic.py``.
Checkpoints hold whole tensors, so scaling from N ranks to M is a
restore with the new mesh's shardings: every leaf is placed on the new
mesh by the logical-axis rules (``train_step.state_shardings``), each
rank keeping its own shard.  Without a mesh the parameters are copied
into the model's own (in place) and the optimizer state is placed on
``model.device``.  The data pipeline is a pure function of (seed, step,
shard), so it re-shards for free.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..checkpoint.ckpt import CheckpointManager
from ..train.train_step import load_train_state, state_shardings


def restore_for_mesh(ckpt: CheckpointManager, model, mesh=None,
                     step: Optional[int] = None):
    """(step, train state, extra) of the checkpoint at ``step`` (the
    latest by default).  Without a mesh ``state["params"]`` are the
    model's parameters, overwritten with the saved values, and ``m``,
    ``v`` and ``step`` new tensors on ``model.device``; with a ``mesh``
    (any shape, any rank count) every leaf is a DTensor placed on it by
    the default rules, and the placed parameters become the model's."""
    shardings = state_shardings(model, mesh) if mesh is not None else None
    saved, state, extra = ckpt.restore(_shapes(model), step=step,
                                       shardings=shardings)
    return saved, load_train_state(model, state), extra


def _shapes(model) -> dict:
    """The train state's structure and shapes, with nothing allocated."""
    shapes = {name: torch.Size(p.shape)
              for name, p in model.named_parameters()}
    return {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                      "step": torch.Size(())}}
