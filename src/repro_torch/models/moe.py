"""Mixture-of-Experts FFN with capacity-based sort dispatch.

The counterpart of the reference's ``repro/models/moe.py:25-82``, step
for step: an fp32 router, softmax, top-k with renormalised gates
(:func:`route`, which also ranks the choices), the Switch load-balance
loss over the B·T·K choices (:func:`balance_loss`), and per batch row a
stable argsort of the T·K expert choices that ranks each choice within
its expert.  A choice ranked at or past the expert's capacity
``max(1, int(T·K·capacity_factor / E))`` is dropped (Switch/GShard
semantics); a decode step (T == 1) is dropless.  The experts' products
are dense einsums over (B, E, capacity, D) slots, as in the reference.

Each kept (row, expert, slot) holds one choice, so dispatch assigns
instead of accumulating (a dropped choice lands in a spare slot past the
capacity, which is cut off: no boolean mask, so the meta tensors of the
dry-run run it too), and the combine adds a token's K contiguous
choices (choice ``i`` belongs to token ``i // K``) in order: the result
on the card is deterministic, where an accumulating ``index_put_`` in
bf16 would not be.

Over a mesh (DTensor x and parameters, ``Model.spmd``) the layer is
expert-parallel (:func:`_on_local_experts`): the router's probabilities
are a DTensor op (the same on every model rank), then each rank routes
its own batch rows, as the reference routes per row, and runs only its
own experts (the ``"expert"`` axis split over ``"model"``: ``wg``,
``wi`` and ``wo`` ``Shard(0)``) on the kept choices that chose them, on
local tensors through ``local_map``; its output is its experts' share, a
partial sum over ``"model"`` that ``layers.settle`` reduces.  The
gradients of x and of the router's probabilities come back partial over
``"model"`` for the same reason.  The load-balance loss takes its two
means over the whole batch (each rank's expert counts summed over the
batch axes before the product: the loss is not linear in the data
split).  An expert axis split over the data axes (``MOE_SERVE_RULES``)
would move tokens to experts by an all-to-all, which is not ported: it
raises.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import cdt


def router_probs(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The router's fp32 softmax over the experts, (B, T, E)."""
    logits = torch.einsum("btd,de->bte", x.float(), p["router"].float())
    return torch.softmax(logits, dim=-1)


def rank_choices(cfg: ArchConfig, probs: torch.Tensor):
    """From probs (B, T, E): (gates (B, T·K) renormalised, expert ids
    (B, T·K), each choice's rank in its expert (B, T·K), capacity)."""
    B, T, _ = probs.shape
    E, K = cfg.n_experts, cfg.top_k
    nk = T * K
    dev = probs.device
    gate_vals, expert_ids = probs.topk(K, dim=-1)              # (B, T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_ids.reshape(B, nk)
    # per-row position-in-expert ranking: a stable sort of the choices
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    newrun = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                        sorted_e[:, 1:] != sorted_e[:, :-1]], dim=1)
    idx = torch.arange(nk, device=dev).expand(B, nk)
    run_start = torch.cummax(torch.where(newrun, idx, 0), dim=1).values
    pos_in_e = torch.zeros((B, nk), dtype=torch.long, device=dev) \
        .scatter_(1, order, idx - run_start)
    if T == 1:
        cap = nk          # decode: dropless (nk = K slots per row)
    else:
        cap = max(1, int(nk * cfg.capacity_factor / E))
    return gate_vals.reshape(B, nk), flat_e, pos_in_e, cap


def route(cfg: ArchConfig, p, x: torch.Tensor):
    """The router of :func:`moe_ffn` on x (B, T, D): (probs (B, T, E),
    gates (B, T·K) renormalised, expert ids (B, T·K), each choice's rank
    in its expert (B, T·K), capacity).  Choice ``i`` of a row is token
    ``i // K``'s; a choice ranked at or past the capacity is dropped."""
    probs = router_probs(cfg, p, x)
    return (probs,) + rank_choices(cfg, probs)


def expert_counts(cfg: ArchConfig, flat_e: torch.Tensor) -> torch.Tensor:
    """The number of choices of each expert, (E,) fp32 (exact: whole
    numbers below 2^24)."""
    ids = flat_e.reshape(-1)
    return torch.zeros(cfg.n_experts, dtype=torch.float32,
                       device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=torch.float32,
                           device=ids.device))


def balance_loss(cfg: ArchConfig, probs: torch.Tensor,
                 counts: torch.Tensor, n_choices: int) -> torch.Tensor:
    """The Switch load-balance loss: coef · E · Σ_e mean_prob(e) ·
    share_of_choices(e), both over the whole batch (``n_choices`` =
    B·T·K).  Over a mesh ``probs`` is batch-split and ``counts`` partial
    over the batch axes: DTensor sums both before the product."""
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = counts * (1.0 / n_choices)
    return cfg.router_aux_coef * cfg.n_experts * torch.sum(me * ce)


def experts(cfg: ArchConfig, x, routing, wg, wi, wo, e0: int = 0):
    """Run the experts ``e0 .. e0 + E_l`` whose weights are given (``wg``,
    ``wi`` (E_l, D, F), ``wo`` (E_l, F, D); all E by default) on the rows
    of x (B, T, D) as ``routing`` (:func:`rank_choices`' gates, expert
    ids, ranks and capacity) sends them: their share of the output
    (B, T, D) in the compute dtype.  A choice of another expert adds
    nothing here."""
    dt = cdt(cfg)
    B, T, D = x.shape
    K = cfg.top_k
    nk = T * K
    dev = x.device
    flat_g, flat_e, pos_in_e, cap = routing
    e_loc = flat_e - e0
    mine = (pos_in_e < cap) & (e_loc >= 0) & (e_loc < wi.shape[0])
    e_idx = torch.where(mine, e_loc, 0)
    tok_idx = torch.arange(nk, device=dev) // K                # token per slot
    bidx = torch.arange(B, device=dev)[:, None].expand(B, nk)

    toks = x.to(dt)[:, tok_idx]                                # (B, T*K, D)
    # a choice not kept here goes to the spare slot ``cap``, cut off below
    disp = torch.zeros((B, wi.shape[0], cap + 1, D), dtype=dt, device=dev)
    disp[bidx, e_idx, torch.where(mine, pos_in_e, cap)] = toks
    disp = disp[:, :, :cap]

    h = F.silu(torch.einsum("becd,edf->becf", disp, wg.to(dt)))
    h = h * torch.einsum("becd,edf->becf", disp, wi.to(dt))
    y = torch.einsum("becf,efd->becd", h, wo.to(dt))           # (B, E_l, C, D)

    gathered = y[bidx, e_idx, torch.where(mine, pos_in_e, 0)]  # (B, T*K, D)
    contrib = (gathered * (flat_g * mine).to(dt)[..., None]) \
        .reshape(B, T, K, D)
    out = contrib[:, :, 0]
    for j in range(1, K):
        out = out + contrib[:, :, j]
    return out


def moe_ffn(cfg: ArchConfig, p, x: torch.Tensor,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D) in the compute dtype, aux_loss)."""
    B, T, _ = x.shape
    n_choices = B * T * cfg.top_k
    if hasattr(x, "device_mesh"):
        probs = router_probs(cfg, p, x)
        out, counts = _on_local_experts(cfg, p, x, probs)
    else:
        probs, *routing = route(cfg, p, x)
        out = experts(cfg, x, routing, p["wg"], p["wi"], p["wo"])
        counts = expert_counts(cfg, routing[1])
    return out, balance_loss(cfg, probs, counts, n_choices)


def _on_local_experts(cfg: ArchConfig, p, x, probs):
    """:func:`experts` of DTensors, each rank on its own batch rows and
    its own experts (or its own slice of every expert's FFN width, when
    the rules split ``"mlp"`` over ``"model"`` instead), through
    ``local_map``: (the output, partial over ``"model"`` when the
    experts are split there, the expert counts, partial over the batch
    axes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..sharding import rules

    raw = getattr(p, "_parameters", p)["wi"]
    names = x.device_mesh.mesh_dim_names
    for n, pl in zip(names, raw.placements):
        if n != "model" and pl == Shard(0):
            raise NotImplementedError(
                f"the MoE's expert axis split over {n!r} "
                "(MOE_SERVE_RULES) moves tokens to their experts by an "
                "all-to-all, which the port does not have: split experts "
                "over 'model' (ROADMAP)")
    mesh = x.device_mesh
    wg, wi, wo = p["wg"], p["wi"], p["wo"]
    batch_axes = rules.batch_sharding(mesh, x.shape[0])
    batch_axes = rules.target_axes(batch_axes[0]) if batch_axes else ()
    rows = [Shard(0) if n in batch_axes else Replicate() for n in names]
    at_model = wi.placements[names.index("model")] if "model" in names \
        else Replicate()
    split = at_model.is_shard()
    by_expert = at_model == Shard(0)
    over_model = [Partial() if n == "model" and split else pl
                  for n, pl in zip(names, rows)]
    counts_at = [Partial() if n in batch_axes else Replicate()
                 for n in names]

    def grad_at(w):
        return [Partial() if n in batch_axes else pl
                for n, pl in zip(names, w.placements)]

    def local(xl, pl, wgl, wil, wol):
        e0 = mesh.get_local_rank("model") * wil.shape[0] if by_expert else 0
        routing = rank_choices(cfg, pl)
        return (experts(cfg, xl, routing, wgl, wil, wol, e0),
                expert_counts(cfg, routing[1]))

    ws = (wg, wi, wo)
    return local_map(
        local, out_placements=(over_model, counts_at),
        in_placements=(rows, rows) + tuple(list(w.placements) for w in ws),
        in_grad_placements=(over_model, over_model)
        + tuple(grad_at(w) for w in ws),
        device_mesh=mesh, redistribute_inputs=True)(x, probs, *ws)
