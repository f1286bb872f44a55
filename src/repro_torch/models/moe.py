"""Mixture-of-Experts FFN with capacity-based sort dispatch.

The counterpart of the reference's ``repro/models/moe.py:25-82``, step
for step: an fp32 router, softmax, top-k with renormalised gates
(:func:`route`, which also ranks the choices), the Switch load-balance
loss over the B·T·K choices, and per batch row a
stable argsort of the T·K expert choices that ranks each choice within
its expert.  A choice ranked at or past the expert's capacity
``max(1, int(T·K·capacity_factor / E))`` is dropped (Switch/GShard
semantics); a decode step (T == 1) is dropless.  The experts' products
are dense einsums over (B, E, capacity, D) slots, as in the reference.

Each kept (row, expert, slot) holds one choice, so dispatch assigns
instead of accumulating, and the combine adds a token's K contiguous
choices (choice ``i`` belongs to token ``i // K``) in order: the result
on the card is deterministic, where an accumulating ``index_put_`` in
bf16 would not be.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import cdt


def route(cfg: ArchConfig, p, x: torch.Tensor):
    """The router of :func:`moe_ffn` on x (B, T, D): (probs (B, T, E),
    gates (B, T·K) renormalised, expert ids (B, T·K), each choice's rank
    in its expert (B, T·K), capacity).  Choice ``i`` of a row is token
    ``i // K``'s; a choice ranked at or past the capacity is dropped."""
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    nk = T * K
    dev = x.device
    logits = torch.einsum("btd,de->bte", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                      # (B, T, E)
    gate_vals, expert_ids = probs.topk(K, dim=-1)              # (B, T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_ids.reshape(B, nk)
    # per-row position-in-expert ranking: a stable sort of the choices
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    newrun = torch.ones((B, nk), dtype=torch.bool, device=dev)
    newrun[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    idx = torch.arange(nk, device=dev).expand(B, nk)
    run_start = torch.cummax(torch.where(newrun, idx, 0), dim=1).values
    pos_in_e = torch.zeros((B, nk), dtype=torch.long, device=dev) \
        .scatter_(1, order, idx - run_start)
    if T == 1:
        cap = nk          # decode: dropless (nk = K slots per row)
    else:
        cap = max(1, int(nk * cfg.capacity_factor / E))
    return probs, gate_vals.reshape(B, nk), flat_e, pos_in_e, cap


def moe_ffn(cfg: ArchConfig, p, x: torch.Tensor,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out (B, T, D) in the compute dtype, aux_loss)."""
    dt = cdt(cfg)
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    nk = T * K
    dev = x.device
    probs, flat_g, flat_e, pos_in_e, cap = route(cfg, p, x)

    # --- load-balance auxiliary loss (Switch-style) ---
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = torch.bincount(flat_e.reshape(-1), minlength=E).float() \
        * (1.0 / (B * T * K))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    keep = pos_in_e < cap
    tok_idx = torch.arange(nk, device=dev) // K                # token per slot
    bidx = torch.arange(B, device=dev)[:, None].expand(B, nk)

    toks = x.to(dt)[:, tok_idx]                                # (B, T*K, D)
    disp = torch.zeros((B, E, cap, D), dtype=dt, device=dev)
    disp[bidx[keep], flat_e[keep], pos_in_e[keep]] = toks[keep]

    h = F.silu(torch.einsum("becd,edf->becf", disp, p["wg"].to(dt)))
    h = h * torch.einsum("becd,edf->becf", disp, p["wi"].to(dt))
    y = torch.einsum("becf,efd->becd", h, p["wo"].to(dt))      # (B, E, C, D)

    slot = torch.where(keep, pos_in_e, 0)
    gathered = y[bidx, flat_e, slot]                           # (B, T*K, D)
    contrib = (gathered * (flat_g * keep).to(dt)[..., None]) \
        .reshape(B, T, K, D)
    out = contrib[:, :, 0]
    for j in range(1, K):
        out = out + contrib[:, :, j]
    return out, aux
