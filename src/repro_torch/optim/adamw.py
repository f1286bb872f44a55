"""AdamW with a cosine schedule and global-norm clipping.

The counterpart of the reference's ``repro/optim/adamw.py``.  The state
mirrors the parameters: ``m`` and ``v`` are fp32 tensors of the
parameters' shapes on their devices, keyed by the same names, and
``step`` is an int32 scalar.  :func:`update` follows the reference term
for term (clip scale ``min(1, clip_norm / max(gnorm, 1e-9))``, bias
correction with the incremented step, weight decay on every parameter,
norms and biases included, the update in fp32), but where the reference
returns new trees it writes the parameters, ``m`` and ``v`` in place
under ``torch.no_grad()`` (a full-width state is four copies of the
parameters; new ones would be more).  Plain tensor ops: the reference
has no kernel here.

On DTensor parameters (training over a mesh) ``m`` and ``v`` are
DTensors placed as the state's shardings say (as the parameters, by
default), ``step`` a replicated one; the update runs in the caller's
``implicit_replication`` (``Model.spmd``): every elementwise op stays on
the local shards, the global gradient norm reduces over every shard, and
moments placed otherwise than their parameter (ZeRO-1) are redistributed
to it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: Union[int, torch.Tensor]) -> torch.Tensor:
    """The learning rate at ``step`` (fp32): linear warmup from 0 over
    ``warmup_steps``, then cosine from ``lr`` to ``lr * min_lr_ratio`` at
    ``decay_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_state(params: Mapping[str, torch.Tensor],
               shardings: Optional[Dict] = None) -> Dict:
    """Zero fp32 ``m`` and ``v`` shaped like each parameter, on its
    device, and ``step`` 0 (int32, on the first parameter's device).
    For DTensor parameters ``shardings`` (``{"m": {name: NamedSharding},
    "v": ..., "step": ...}``, ``train_step.state_shardings(...)["opt"]``)
    places each; each rank allocates only its own shards."""
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)

    def zeros(key):
        if shardings is None:
            return {name: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                    for name, p in params.items()}
        return {name: _placed_zeros(p, shardings[key][name])
                for name, p in params.items()}
    if shardings is not None:
        from ..sharding.rules import place
        step = place(step, shardings["step"])
    return {"m": zeros("m"), "v": zeros("v"), "step": step}


def _placed_zeros(p, sharding):
    """Zero fp32 ``m`` or ``v`` of DTensor ``p`` placed by ``sharding``:
    only the local shard is allocated where the placements are ``p``'s."""
    if list(p.placements) == list(sharding.placements):
        return torch.zeros_like(p, dtype=torch.float32)
    from ..sharding.rules import place
    return place(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                 sharding)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@torch.no_grad()
def update(cfg: OptConfig, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: Dict,
           ) -> Tuple[Mapping[str, torch.Tensor], Dict,
                      Dict[str, torch.Tensor]]:
    """One AdamW step: writes ``params``, ``state["m"]`` and
    ``state["v"]`` in place and returns (params, the state with its step
    incremented, {"grad_norm", "lr"}).  ``grads`` (any float dtype,
    keyed as ``params``) is read, not written."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float()
        if hasattr(m, "device_mesh") and m.placements != g.placements:
            g = g.redistribute(m.device_mesh, m.placements)
        g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        pf = p.float()
        if hasattr(m, "device_mesh") and m.placements != p.placements:
            pf = pf.redistribute(m.device_mesh, m.placements)
        step_dir = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        new = pf - lr * step_dir
        if hasattr(m, "device_mesh") and m.placements != p.placements:
            new = new.redistribute(p.device_mesh, p.placements)
        p.copy_(new)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
