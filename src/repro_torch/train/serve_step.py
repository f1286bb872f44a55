"""Serving steps: prefill, single-token decode and greedy generation.

The counterpart of the reference's ``repro/train/serve_step.py``.  The
reference jit-compiles its steps; the port runs them eagerly on the
model's device.  Everything stays there (logits, caches, the tokens fed
back) but the tokens :func:`greedy_generate` returns, which come back to
the host once, at the end.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models import Model
from ..models.kvcache import pad_caches


def make_prefill_step(model: Model):
    return model.prefill


def make_decode_step(model: Model):
    return model.decode


def greedy_generate(model: Model, batch: Dict, steps: int) -> torch.Tensor:
    """Greedy decoding of ``batch["tokens"]`` (with the batch's image or
    audio embeds, which the prefill reads and the caches keep): the
    argmax of the prefill's logits, then ``steps
    - 1`` decode steps that each feed the last token back.  Returns the
    ``steps`` tokens (B, steps) as int32 on the CPU."""
    logits, caches = model.prefill(batch)
    caches = pad_caches(model.cfg, caches, steps)
    tok = logits.argmax(-1).to(torch.int32)
    t0 = batch["tokens"].shape[1]
    out = [tok]
    for i in range(steps - 1):
        logits, caches = model.decode(caches, tok[:, None], t0 + i)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1).cpu()
