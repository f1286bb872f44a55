"""Training step: loss and gradients (with microbatch accumulation and the
gradient dtype), then the AdamW update.

The counterpart of the reference's ``repro/train/train_step.py``.  The
train state is ``{"params": the model's parameters by state-dict name,
"opt": adamw state}``; the parameters are the model's own tensors, and
the step updates them, and the optimizer state, in place.

Over a mesh (a ``DeviceMesh`` with dimensions named ``("data",
"model")`` or ``("pod", "data", "model")``) the parameters are DTensors
placed by the logical-axis rules (:func:`state_shardings`,
``sharding/rules.py``), ``m`` and ``v`` are placed alike, ``step`` is
replicated, and the batch is split over the data (and pod) axes; the
model's code runs on them unchanged (``Model.spmd``), with attention on
each rank's own heads (``kernels/flash_attention/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from ..optim import adamw
from ..sharding import rules as shr

__all__ = ["TrainConfig", "init_train_state", "load_train_state",
           "make_train_step", "place_parameters", "place_train_state",
           "state_shardings"]

GRAD_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_dtype: str = "float32"   # "bfloat16" = compressed DP all-reduce
    opt: adamw.OptConfig = field(default_factory=adamw.OptConfig)


def state_shardings(model, mesh, rules=None, opt_rules=None) -> Dict:
    """The train state's shardings on ``mesh`` (a ``DeviceMesh`` or a mesh
    shape): every parameter by ``rules`` (DEFAULT_RULES when None) from
    its logical axes, ``m`` and ``v`` by ``opt_rules`` when given (ZeRO-1:
    parameters split for compute only, moments split further), else as
    the parameters, and ``step`` replicated."""
    logical, shapes = model.logical_axes(), model.param_shapes()
    p = shr.tree_shardings(mesh, logical, shapes, rules)
    o = p if opt_rules is None else shr.tree_shardings(
        mesh, logical, shapes, opt_rules)
    return {"params": p, "opt": {"m": o, "v": o,
                                 "step": shr.NamedSharding(mesh, ())}}


def _swap_parameters(model, make: Callable) -> Dict:
    """Replace every parameter ``p`` of ``model`` (named ``name``) by a new
    parameter holding ``make(name, p)``, keeping its spec."""
    names = {id(p): n for n, p in model.named_parameters()}
    for module in model.modules():
        for key, p in list(module._parameters.items()):
            new = torch.nn.Parameter(make(names[id(p)], p))
            new.spec = p.spec
            module._parameters[key] = new
    return dict(model.named_parameters())


def place_parameters(model, shardings: Dict, dtype=torch.float32) -> Dict:
    """Replace each parameter of ``model`` by a DTensor parameter placed by
    ``shardings[name]`` (``rules.place``: each rank keeps its own shard,
    in ``dtype``; a parameter on the meta device gives a meta shard).
    Returns the parameters by name."""
    return _swap_parameters(
        model, lambda name, p: shr.place(p, shardings[name], dtype))


def init_train_state(model, mesh=None, shardings: Optional[Dict] = None
                     ) -> Dict:
    """The model's parameters as they stand, and a fresh optimizer state.
    With a ``mesh`` the parameters are first placed on it by
    ``shardings`` (:func:`state_shardings` by default), and ``m``, ``v``
    and ``step`` are made placed."""
    if mesh is None:
        params = dict(model.named_parameters())
        return {"params": params, "opt": adamw.init_state(params)}
    shardings = shardings or state_shardings(model, mesh)
    params = place_parameters(model, shardings["params"])
    return {"params": params,
            "opt": adamw.init_state(params, shardings["opt"])}


def place_train_state(model, state: Dict, mesh,
                      shardings: Optional[Dict] = None) -> Dict:
    """A train state held whole on every rank (the model's parameters and
    plain ``m``, ``v``, ``step``), placed on ``mesh`` by ``shardings``
    (:func:`state_shardings` by default): the parameters become the
    model's DTensor parameters."""
    shardings = shardings or state_shardings(model, mesh)
    params = place_parameters(model, shardings["params"])
    opt = {key: {name: shr.place(t, shardings["opt"][key][name])
                 for name, t in state["opt"][key].items()}
           for key in ("m", "v")}
    opt["step"] = shr.place(state["opt"]["step"], shardings["opt"]["step"])
    return {"params": params, "opt": opt}


def load_train_state(model, state: Dict) -> Dict:
    """A train state for ``model`` from one held elsewhere (a checkpoint
    restored to the host, ``convert.train_state_from_reference``): the
    parameters are copied into the model's own, in place; ``m``, ``v``
    and ``step`` are placed on ``model.device``.  A state whose leaves
    are DTensors (a checkpoint restored onto a mesh) becomes the model's
    parameters and optimizer state as it is."""
    if hasattr(state["opt"]["step"], "device_mesh"):
        params = _swap_parameters(model,
                                  lambda name, p: state["params"][name])
        return {"params": params, "opt": state["opt"]}
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


def split_microbatches(batch: Dict, mb: int) -> list:
    """``mb`` microbatches of ``batch``: rows ``i * B / mb`` onwards of
    each entry.  A DTensor entry is split rank by rank: each rank's own
    shard (B / data ranks rows) into ``mb`` pieces, each wrapped back with
    the entry's placements, so every microbatch keeps the whole data
    split (reshaping the global tensor to (mb, B / mb) would put its
    ``Shard(0)`` on the ``mb`` dimension).  Microbatch i then holds the
    i-th piece of every rank's shard, other rows than the unsplit
    batch's i-th: equal token counts a microbatch (no mask, or a uniform
    one) give the same mean loss and gradients."""
    out = [dict() for _ in range(mb)]
    for k, v in batch.items():
        if hasattr(v, "device_mesh"):
            from torch.distributed.tensor import DTensor
            local = v.to_local()
            parts = local.reshape((mb, local.shape[0] // mb)
                                  + local.shape[1:])
            shape = (v.shape[0] // mb,) + tuple(v.shape[1:])
            for i in range(mb):
                out[i][k] = DTensor.from_local(
                    parts[i], v.device_mesh, v.placements, run_check=False,
                    shape=shape, stride=parts[i].stride())
        else:
            parts = v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
            for i in range(mb):
                out[i][k] = parts[i]
    return out


def reduce_grads(grads, params) -> list:
    """Each DTensor gradient redistributed to its parameter's placements:
    the partial sums over the axes the parameter is not split over (the
    data axis, and the model axis for a parameter it replicates) are
    all-reduced, in the gradients' dtype."""
    return [g.redistribute(p.device_mesh, p.placements)
            for g, p in zip(grads, params)]


def make_train_step(model, tcfg: TrainConfig, mesh=None) -> Callable:
    """Returns step(state, batch) -> (state, metrics), as the
    reference's.  ``batch`` holds ``tokens`` and ``targets`` (B, T) and
    optionally ``mask``, as numpy arrays or tensors.

    With ``microbatches`` mb > 1 the batch is split
    (:func:`split_microbatches`); each microbatch's gradients come from
    ``torch.autograd.grad``, are cast to ``grad_dtype`` and added, in
    that dtype, into one buffer a parameter (the first microbatch's cast
    gradients become the buffer: 0 + g is g), each freed as soon as it
    is added; the sum is divided by mb in that dtype.  A bf16
    ``grad_dtype`` therefore rounds at every add, as the reference's
    does.  Metrics: ``loss``, ``grad_norm`` and ``lr``, plus ``ce``,
    ``aux`` and ``tokens`` when mb is 1 (0-dim plain tensors on the
    model's device).

    With a ``mesh`` the state must come from ``init_train_state(model,
    mesh)`` (or a restore onto a mesh); each batch entry is placed by
    ``rules.constrain_batch`` (split over the data and pod axes,
    replicated when they do not divide B); the gradients come back
    partial over the axes the parameters are not split over, and are
    reduced once a step, after the microbatches and in ``grad_dtype``,
    to the parameters' placements (the data-axis all-reduce)."""
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
        if (mesh is None) == hasattr(own[0], "device_mesh"):
            raise ValueError("the train state is placed on a mesh and the "
                             "step is not, or the other way round")
        batch = {k: v if hasattr(v, "device_mesh")
                 else torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if mesh is not None:
            batch = {k: shr.constrain_batch(v, mesh)
                     for k, v in batch.items()}
        with model.spmd():
            if mb > 1:
                acc = [None] * len(params)
                loss_sum = torch.zeros((), device=model.device)
                for part in split_microbatches(batch, mb):
                    loss, _, grads = grads_of(params, part)
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
            if mesh is not None:
                acc = reduce_grads(acc, params.values())
            grads = dict(zip(params, acc))
            del acc
            _, opt, opt_metrics = adamw.update(tcfg.opt, params, grads,
                                               state["opt"])
            del grads
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics = {k: v.full_tensor() if hasattr(v, "device_mesh") else v
                   for k, v in metrics.items()}
        return {"params": params, "opt": opt}, metrics

    return step
