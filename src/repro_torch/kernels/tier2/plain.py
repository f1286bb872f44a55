"""Plain PyTorch tier-2 table ops: the contract the CUDA kernels
(``cuda.py``) are held to.

The counterparts of the reference's XLA op chains
(``repro/core/cache.py``: ``_hash_sets``, ``_probe``, ``_insert``,
``_probe_payload``), bit for bit: same hash, same victim choice, same
one-writer-per-set election.  Tables are ``(S, W)`` tensors: S sets, W
ways.  Every op works on all C rows of its chunk, live or not, through
``(C, W)`` gathers of the table; ``core/cache.py`` runs them on CPU
tensors and documents their contracts.
"""
from __future__ import annotations

import torch

__all__ = ["hash_sets", "probe", "insert", "probe_payload"]

_MIX = -7046029254386353131  # 0x9E3779B97F4A7C15 as signed int64


def hash_sets(keys: torch.Tensor, n_sets: int) -> torch.Tensor:
    """Set index of each int64 key: a wraparound multiply, an arithmetic
    shift and a floor modulo (``remainder``, not ``fmod``), as the
    reference computes it."""
    h = keys * _MIX
    h = h ^ (h >> 29)
    return torch.remainder(torch.abs(h), n_sets)


def probe(tkeys, tvals, tused, tstamp, keys, active, tick: int):
    """Batched lookup; returns (hit, vals, stamp') — stamp' records the LRU
    touch of every hit way (scatter-max, so duplicate rows are harmless)."""
    n_sets, W = tkeys.shape
    sets = hash_sets(keys, n_sets)
    match = tused[sets] & (tkeys[sets] == keys[:, None]) & active[:, None]
    hit = match.any(dim=1)
    way = match.to(torch.int8).argmax(dim=1)  # first matching way
    vals = torch.where(hit, tvals[sets, way], 0)
    stamp = tstamp.reshape(-1).scatter_reduce(
        0, sets * W + way, torch.where(hit, tick, -1).to(tstamp.dtype),
        "amax").reshape(n_sets, W)
    return hit, vals, stamp


def insert(tkeys, tvals, tused, tstamp, tcost, keys, vals, costs, active,
           tick: int, *, policy: str, rounds: int = 1, pay=None):
    """Batched fill (see ``core/cache.py::_insert``).

    The election is a scatter-max of the row index: duplicate-index
    scatters must not carry the write mask, or a masked row's "keep old
    value" no-op could land after a real admit and clobber it.  Writes go
    through per-set *unique* indices: on CUDA an index_put_ with duplicate
    indices has no defined winner."""
    n_sets = tkeys.shape[0]
    C = keys.shape[0]
    dev = keys.device
    tkeys, tvals, tused = tkeys.clone(), tvals.clone(), tused.clone()
    tstamp, tcost = tstamp.clone(), tcost.clone()
    if pay is not None:
        tpoff, tplen, poff, plen = pay
        tpoff, tplen = tpoff.clone(), tplen.clone()
        cand_pay = plen >= 0
    rows = torch.arange(C, dtype=torch.int32, device=dev)
    set_ids = torch.arange(n_sets, device=dev)
    sets = torch.where(active, hash_sets(keys, n_sets), 0)
    remaining = active
    no_res = torch.zeros(C, dtype=torch.bool, device=dev)
    n_admit = torch.zeros((), dtype=torch.int32, device=dev)
    n_evict = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max(1, rounds)):
        way_used = tused[sets]                       # (C, W)
        resident = way_used & (tkeys[sets] == keys[:, None])
        if pay is not None:
            blocking = resident & ((tplen[sets] >= 0) | ~cand_pay[:, None])
        else:
            blocking = resident                      # dup already admitted
        rem = remaining & ~blocking.any(dim=1)
        any_free = ~way_used.all(dim=1)
        free_way = way_used.to(torch.int8).argmin(dim=1)  # first invalid way
        if policy == "costaware":
            contested = torch.where(way_used, tcost[sets],
                                    2 ** 62).argmin(dim=1)
        else:  # direct (W=1 → way 0) and setassoc both take the LRU way
            contested = torch.where(way_used, tstamp[sets],
                                    2 ** 31 - 1).argmin(dim=1)
        victim = torch.where(any_free, free_way, contested)
        has_res = no_res
        if pay is not None:
            # a payload-less resident is refreshed in its own way
            has_res = resident.any(dim=1)
            victim = torch.where(has_res,
                                 resident.to(torch.int8).argmax(dim=1),
                                 victim)
        admit = rem
        if policy == "costaware":
            incumbent = tcost[sets, victim]
            admit = admit & (has_res | any_free | (costs >= incumbent))
        # elect one admitted writer per set (highest row index)
        winner = torch.full((n_sets,), -1, dtype=torch.int32,
                            device=dev).scatter_reduce_(
            0, sets, torch.where(admit, rows, -1), "amax")
        src = winner.clamp(0, C - 1)                 # (S,) winning row
        do_w = winner >= 0
        sel = (set_ids, victim[src])                 # unique per set
        tkeys[sel] = torch.where(do_w, keys[src], tkeys[sel])
        tvals[sel] = torch.where(do_w, vals[src], tvals[sel])
        tcost[sel] = torch.where(do_w, costs[src], tcost[sel])
        tstamp[sel] = torch.where(do_w, tick, tstamp[sel]).to(tstamp.dtype)
        if pay is not None:
            tpoff[sel] = torch.where(do_w, poff[src], tpoff[sel])
            tplen[sel] = torch.where(do_w, plen[src], tplen[sel])
        tused[sel] = tused[sel] | do_w
        won = admit & (winner[sets] == rows)
        n_admit = n_admit + won.sum(dtype=torch.int32)
        n_evict = n_evict + (won & ~any_free & ~has_res).sum(
            dtype=torch.int32)
        remaining = rem & ~won
    if pay is not None:
        return (tkeys, tvals, tused, tstamp, tcost, tpoff, tplen, n_admit,
                n_evict)
    return tkeys, tvals, tused, tstamp, tcost, n_admit, n_evict


def probe_payload(tkeys, tused, tstamp, tpoff, tplen, keys, active,
                  tick: int):
    """Evaluation-mode lookup (see ``core/cache.py::_probe_payload``)."""
    n_sets, W = tkeys.shape
    sets = hash_sets(keys, n_sets)
    match = (tused[sets] & (tkeys[sets] == keys[:, None])
             & (tplen[sets] >= 0) & active[:, None])
    hit = match.any(dim=1)
    way = match.to(torch.int8).argmax(dim=1)  # first matching way
    poff = torch.where(hit, tpoff[sets, way], 0)
    plen = torch.where(hit, tplen[sets, way], 0)
    stamp = tstamp.reshape(-1).scatter_reduce(
        0, sets * W + way, torch.where(hit, tick, -1).to(tstamp.dtype),
        "amax").reshape(n_sets, W)
    return hit, poff, plen, stamp
