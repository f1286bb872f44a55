"""Restore a checkpointed train state onto the model's device.

The counterpart of the reference's ``repro/runtime/elastic.py`` without a
mesh: checkpoints hold whole tensors, so a restore copies the parameters
into the model's own (in place) and places the optimizer state on
``model.device``.  Restoring under a mesh waits for the multi-card slice
(ROADMAP Queue 1, item 4e).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..checkpoint.ckpt import CheckpointManager
from ..train.train_step import load_train_state


def restore_for_mesh(ckpt: CheckpointManager, model, mesh=None,
                     step: Optional[int] = None):
    """(step, train state, extra) of the checkpoint at ``step`` (the
    latest by default): ``state["params"]`` are the model's parameters,
    overwritten with the saved values; ``m``, ``v`` and ``step`` are new
    tensors on ``model.device``."""
    if mesh is not None:
        raise NotImplementedError(
            "restoring under a mesh waits for training on several cards "
            "(ROADMAP Queue 1, item 4e)")
    saved, host, extra = ckpt.restore(_shapes(model), step=step)
    return saved, load_train_state(model, host), extra


def _shapes(model) -> dict:
    """The train state's structure and shapes, with nothing allocated."""
    shapes = {name: torch.Size(p.shape)
              for name, p in model.named_parameters()}
    return {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                      "step": torch.Size(())}}
