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
own experts on local tensors through ``local_map``.  Where the rules
split the ``"expert"`` axis over ``"model"`` (the default: ``wg``,
``wi`` and ``wo`` ``Shard(0)`` there) a rank runs its experts on the
kept choices of its rows that chose them; its output is its experts'
share, a partial sum over ``"model"`` that ``layers.settle`` reduces.
Where they split it over the data axes (``MOE_SERVE_RULES``: experts
resident, tokens travel) a rank fills the slots of all E experts from
its rows (:func:`dispatch`), sends each data rank the slots of that
rank's experts by an all-to-all over the ranks that share its
``"model"`` coordinate (:func:`all_to_all`, whose backward is the
reverse exchange), runs its experts on what every data rank sent
(:func:`ffn`, on its slice of their FFN width when ``"mlp"`` is split
over ``"model"``: a partial sum there), and gets its rows' results back
by a second all-to-all (:func:`combine` adds them up); a batch the data
axes do not split (B = 1 on a data axis of 2) moves no token: each rank
runs its experts on every row, a partial sum over the expert axes too.
The values do not depend on the split: routing and capacity are per
row.  The gradients of x and of the router's probabilities come back
partial over ``"model"`` for the same reason.  The load-balance loss
takes its two means over the whole batch (each rank's expert counts
summed over the batch axes before the product: the loss is not linear
in the data split).
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


def dispatch(cfg: ArchConfig, x, routing, n_experts: int, e0: int = 0):
    """The kept choices of the experts ``e0 .. e0 + n_experts`` of x's rows
    (B, T, D), as ``routing`` (:func:`rank_choices`' gates, expert ids,
    ranks and capacity) sends them, in their slots: (disp (B, n_experts,
    capacity, D) in the compute dtype, each choice's (row, expert, slot,
    kept) (B, T·K) for :func:`combine`).  A choice of another expert
    fills no slot."""
    dt = cdt(cfg)
    B, T, D = x.shape
    K = cfg.top_k
    nk = T * K
    dev = x.device
    _, flat_e, pos_in_e, cap = routing
    e_loc = flat_e - e0
    mine = (pos_in_e < cap) & (e_loc >= 0) & (e_loc < n_experts)
    e_idx = torch.where(mine, e_loc, 0)
    tok_idx = torch.arange(nk, device=dev) // K                # token per slot
    bidx = torch.arange(B, device=dev)[:, None].expand(B, nk)

    toks = x.to(dt)[:, tok_idx]                                # (B, T*K, D)
    # a choice not kept here goes to the spare slot ``cap``, cut off below
    disp = torch.zeros((B, n_experts, cap + 1, D), dtype=dt, device=dev)
    disp[bidx, e_idx, torch.where(mine, pos_in_e, cap)] = toks
    return disp[:, :, :cap], (bidx, e_idx, torch.where(mine, pos_in_e, 0),
                              mine)


def ffn(cfg: ArchConfig, disp, wg, wi, wo):
    """The experts whose weights are given (``wg``, ``wi`` (E_l, D, F),
    ``wo`` (E_l, F, D)) on their slots disp (N, E_l, capacity, D): (N,
    E_l, capacity, D) in the compute dtype."""
    dt = cdt(cfg)
    h = F.silu(torch.einsum("becd,edf->becf", disp, wg.to(dt)))
    h = h * torch.einsum("becd,edf->becf", disp, wi.to(dt))
    return torch.einsum("becf,efd->becd", h, wo.to(dt))


def combine(cfg: ArchConfig, y, routing, slots):
    """The rows' output (B, T, D) from the experts' results y (B, E_l,
    capacity, D) in the slots :func:`dispatch` gave (``slots``): each
    token's K choices, gated, added in order."""
    dt = cdt(cfg)
    bidx, e_idx, slot, mine = slots
    flat_g = routing[0]
    B, nk = flat_g.shape
    K = cfg.top_k
    D = y.shape[-1]
    gathered = y[bidx, e_idx, slot]                            # (B, T*K, D)
    contrib = (gathered * (flat_g * mine).to(dt)[..., None]) \
        .reshape(B, nk // K, K, D)
    out = contrib[:, :, 0]
    for j in range(1, K):
        out = out + contrib[:, :, j]
    return out


def experts(cfg: ArchConfig, x, routing, wg, wi, wo, e0: int = 0):
    """Run the experts ``e0 .. e0 + E_l`` whose weights are given (all E
    by default) on the rows of x (B, T, D) as ``routing`` sends them:
    their share of the output (B, T, D) in the compute dtype."""
    disp, slots = dispatch(cfg, x, routing, wi.shape[0], e0)
    return combine(cfg, ffn(cfg, disp, wg, wi, wo), routing, slots)


# the bytes :func:`all_to_all` has received on this rank (forward and
# backward exchanges alike): what the cost probe counts of its c10d op
exchanged_bytes = 0


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """c10d's ``all_to_all_single`` of x over ``group``, in equal chunks
    of its leading dimension (the group's size): chunk k goes to the
    group's rank k, and chunk k of the result came from it."""
    global exchanged_bytes
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    exchanged_bytes += out.numel() * out.element_size()
    return out


class _AllToAll(torch.autograd.Function):
    """:func:`_exchange`, whose backward is the reverse exchange of the
    gradient (an equal-split all-to-all is its own inverse's pattern)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """The token exchange of the expert-data MoE: x (d, ...) with chunk k
    sent to rank k of ``group`` (d ranks), differentiable."""
    return _AllToAll.apply(x, group)


def exchanged(cfg: ArchConfig, x, routing, wg, wi, wo, group):
    """The experts of every rank of ``group`` (d ranks, rank k holding
    experts ``k·E/d .. (k+1)·E/d``, whose weights, or their slice of the
    FFN width, are given) on this rank's rows x (B_l, T, D): the slots
    of all E experts go to their ranks by :func:`all_to_all`, each rank
    runs its experts on every rank's slots, and the results come back
    by a second one.  The output (B_l, T, D) in the compute dtype."""
    d = group.size()
    disp, slots = dispatch(cfg, x, routing, cfg.n_experts)
    B, E, cap, D = disp.shape
    send = disp.reshape(B, d, E // d, cap, D).transpose(0, 1)
    got = all_to_all(send, group)              # (d, B_l, E/d, cap, D)
    y = ffn(cfg, got.reshape(d * B, E // d, cap, D), wg, wi, wo)
    back = all_to_all(y.reshape(d, B, E // d, cap, D), group)
    return combine(cfg, back.transpose(0, 1).reshape(B, E, cap, D),
                   routing, slots)


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


def _expert_group(mesh, axes):
    """The process group of the ranks that share this rank's coordinates
    but on ``axes`` (one axis, or ``("pod", "data")`` flattened: its
    ranks in the order the experts are split, pod-major), built once a
    mesh and kept on it."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_expert_groups", {})
    if axes not in groups:
        groups[axes] = mesh[axes]._flatten().get_group()
    return groups[axes]


def _on_local_experts(cfg: ArchConfig, p, x, probs):
    """:func:`experts` of DTensors, each rank on its own batch rows and
    its own experts (or its own slice of every expert's FFN width, when
    the rules split ``"mlp"`` over ``"model"`` instead), through
    ``local_map``; experts split over the data axes exchange the rows'
    slots (:func:`exchanged`) when the batch is split there too.  Returns
    (the output, partial over ``"model"`` when it splits the experts or
    their width, and over the expert axes when no token moved; the
    expert counts, partial over the batch axes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..sharding import rules

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    # the placed weights: ``p[name]`` gathers a split over the data axes
    raw = getattr(p, "_parameters", p)
    by = [n for n, pl in zip(names, raw["wi"].placements) if pl == Shard(0)]
    ex_axes = tuple(n for n in by if n != "model")
    ws = tuple(raw[k] if ex_axes else p[k] for k in ("wg", "wi", "wo"))
    batch_axes = rules.batch_sharding(mesh, x.shape[0])
    batch_axes = rules.target_axes(batch_axes[0]) if batch_axes else ()
    rows = [Shard(0) if n in batch_axes else Replicate() for n in names]
    split = "model" in names and ws[1].placements[names.index("model")] \
        .is_shard()
    move = bool(ex_axes) and tuple(batch_axes) == ex_axes
    group = _expert_group(mesh, ex_axes) if move else None
    partial = ({"model"} if split else set()) \
        | (set() if move else set(ex_axes))
    out_at = [Partial() if n in partial else pl
              for n, pl in zip(names, rows)]
    counts_at = [Partial() if n in batch_axes else Replicate()
                 for n in names]
    e_rank = 0
    for n in by:
        e_rank = e_rank * mesh.size(names.index(n)) + mesh.get_local_rank(n)

    def grad_at(w):
        return [Partial() if n in batch_axes and not pl.is_shard() else pl
                for n, pl in zip(names, w.placements)]

    def local(xl, pl, wgl, wil, wol):
        routing = rank_choices(cfg, pl)
        out = exchanged(cfg, xl, routing, wgl, wil, wol, group) if move \
            else experts(cfg, xl, routing, wgl, wil, wol,
                         e_rank * wil.shape[0])
        return out, expert_counts(cfg, routing[1])

    return local_map(
        local, out_placements=(out_at, counts_at),
        in_placements=(rows, rows) + tuple(list(w.placements) for w in ws),
        in_grad_placements=(out_at, out_at) + tuple(grad_at(w) for w in ws),
        device_mesh=mesh, redistribute_inputs=True)(x, probs, *ws)
