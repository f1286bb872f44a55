"""Training step: loss and gradients (with microbatch accumulation and the
gradient dtype), then the AdamW update.

The counterpart of the reference's ``repro/train/train_step.py`` on one
device (its ``mesh`` branch and ``state_shardings`` wait for the
multi-card slice, ROADMAP Queue 1, item 4e).  The train state is ``{"params":
the model's parameters by state-dict name, "opt": adamw state}``; the
parameters are the model's own tensors, and the step updates them, and
the optimizer state, in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import torch

from ..optim import adamw

__all__ = ["TrainConfig", "init_train_state", "load_train_state",
           "make_train_step"]

GRAD_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_dtype: str = "float32"   # "bfloat16" = compressed DP all-reduce
    opt: adamw.OptConfig = field(default_factory=adamw.OptConfig)


def init_train_state(model) -> Dict:
    """The model's parameters as they stand, and a fresh optimizer state."""
    params = dict(model.named_parameters())
    return {"params": params, "opt": adamw.init_state(params)}


def load_train_state(model, state: Dict) -> Dict:
    """A train state for ``model`` from one held elsewhere (a checkpoint
    restored to the host, ``convert.train_state_from_reference``): the
    parameters are copied into the model's own, in place; ``m``, ``v``
    and ``step`` are placed on ``model.device``."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state["params"][name])
    opt = state["opt"]
    dev = model.device
    return {"params": params,
            "opt": {"m": {k: t.to(dev) for k, t in opt["m"].items()},
                    "v": {k: t.to(dev) for k, t in opt["v"].items()},
                    "step": opt["step"].to(dev)}}


def make_train_step(model, tcfg: TrainConfig) -> Callable:
    """Returns step(state, batch) -> (state, metrics), as the
    reference's.  ``batch`` holds ``tokens`` and ``targets`` (B, T) and
    optionally ``mask``, as numpy arrays or tensors.

    With ``microbatches`` mb > 1 every entry is reshaped (mb, B / mb,
    ...); each microbatch's gradients come from ``torch.autograd.grad``,
    are cast to ``grad_dtype`` and added, in that dtype, into one
    buffer a parameter (the first microbatch's cast gradients become
    the buffer: 0 + g is g), each freed as soon as it is added; the sum
    is divided by mb in that dtype.  A bf16 ``grad_dtype`` therefore
    rounds at every add, as the reference's does.  Metrics: ``loss``,
    ``grad_norm`` and ``lr``, plus ``ce``, ``aux`` and ``tokens`` when
    mb is 1 (0-dim tensors on the model's device)."""
    if tcfg.grad_dtype not in GRAD_DTYPES:
        raise ValueError(f"grad_dtype {tcfg.grad_dtype!r}: one of "
                         f"{tuple(GRAD_DTYPES)}")
    gdt = GRAD_DTYPES[tcfg.grad_dtype]
    mb = tcfg.microbatches

    def grads_of(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, grads

    def step(state, batch) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        params = state["params"]
        own = list(model.parameters())
        if len(params) != len(own) or any(
                a is not b for a, b in zip(params.values(), own)):
            raise ValueError("state['params'] are not this model's "
                             "parameters (init_train_state(model))")
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if mb > 1:
            parts = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                     for k, v in batch.items()}
            acc = [None] * len(params)
            loss_sum = torch.zeros((), device=model.device)
            for i in range(mb):
                loss, _, grads = grads_of(
                    params, {k: v[i] for k, v in parts.items()})
                grads = list(grads)
                for j, g in enumerate(grads):
                    grads[j] = None          # g is the last reference
                    g = g.to(gdt)
                    if acc[j] is None:
                        acc[j] = g
                    else:
                        acc[j].add_(g)
                del g
                loss_sum = loss_sum + loss
            for g in acc:
                g.div_(mb)
            metrics = {"loss": loss_sum / mb}
        else:
            _, metrics, acc = grads_of(params, batch)
            acc = [g.to(gdt) for g in acc]
        grads = dict(zip(params, acc))
        del acc
        _, opt, opt_metrics = adamw.update(tcfg.opt, params, grads,
                                           state["opt"])
        del grads
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return {"params": params, "opt": opt}, metrics

    return step
