"""Serving steps: prefill, single-token decode and greedy generation.

The counterpart of the reference's ``repro/train/serve_step.py``.  The
reference jit-compiles its steps; the port runs them eagerly on the
model's device.  Everything stays there (logits, caches, the tokens fed
back) but the tokens :func:`greedy_generate` returns, which come back to
the host once, at the end.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator

import torch

from ..models import Model
from ..models.kvcache import pad_caches
from ..sharding import rules


def make_prefill_step(model: Model):
    return model.prefill


def make_decode_step(model: Model):
    return model.decode


def greedy_logits(model: Model, batch: Dict, steps: int, mesh=None
                  ) -> Iterator[torch.Tensor]:
    """Greedy decoding of ``batch["tokens"]`` call by call: yields the
    logits (B, V) of the prefill (which reads the batch's image or audio
    embeds; the caches keep them), then of ``steps`` decode steps, each
    fed the argmax of the last logits (int32), from caches padded by
    ``steps`` slots.  Over ``mesh`` (run it under ``model.spmd()``) the
    rows are split over the data axes where they divide them, and the
    logits come back whole."""
    def place(t):
        return t if mesh is None else rules.constrain_batch(t, mesh)

    def whole(t):
        return t if mesh is None else t.full_tensor()
    logits, caches = model.prefill(dict(batch,
                                        tokens=place(batch["tokens"])))
    caches = pad_caches(model.cfg, caches, steps)
    logits = whole(logits)
    t0 = batch["tokens"].shape[1]
    for i in range(steps):
        yield logits
        tok = logits.argmax(-1).to(torch.int32)
        logits, caches = model.decode(caches, place(tok[:, None]), t0 + i)
        logits = whole(logits)
    yield logits


def greedy_generate(model: Model, batch: Dict, steps: int) -> torch.Tensor:
    """Greedy decoding of ``batch["tokens"]`` (with the batch's image or
    audio embeds, which the prefill reads and the caches keep): the
    argmax of the prefill's logits, then ``steps
    - 1`` decode steps that each feed the last token back
    (:func:`greedy_logits`).  Returns the ``steps`` tokens (B, steps) as
    int32 on the CPU."""
    calls = itertools.islice(greedy_logits(model, batch, steps), steps)
    return torch.stack([logits.argmax(-1).to(torch.int32)
                        for logits in calls], dim=1).cpu()
