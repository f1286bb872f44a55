"""Pluggable tier-2 device cache for the vectorized CLFTJ, count region.

The paper's central knob is *flexibility*: "our solution balances memory
usage and repeated computation" by choosing how much cache to keep and what
to admit/evict (§3.4, Fig 10).  The frontier engine realizes the cache as
device tensors, so a "policy" here is a pair of ops (probe, insert) over a
fixed table layout:

* ``direct``    — 1-way direct-mapped table: ``slot = hash(key) % S``;
  collisions overwrite unconditionally (hardware-style, zero metadata).
* ``setassoc``  — N-way set-associative with LRU within each set: a key may
  live in any of ``assoc`` ways of its set; the victim is the invalid way
  if one exists, else the least-recently-touched way.
* ``costaware`` — set-associative layout, but the victim is the *cheapest*
  resident entry and admission is refused when the incumbent is more
  valuable than the candidate.  Cost is the cached subtree count.

All policies are *caches of exact results*: correctness never depends on
what is resident, only speed does (the paper's optionality property).  The
ops are bit-for-bit twins of the reference's (``repro/core/cache.py``):
same hash, same victim choice, same one-writer-per-set election, so the
tables and their statistics match the reference's exactly.  On a CUDA
chunk they are the kernels of ``csrc/tier2.cu``, whose work follows the
live rows; on a CPU chunk the op chains of ``kernels/tier2/plain.py``.

``CacheManager`` owns one ``DeviceCache`` per TD node and the **dynamic
sizing controller**: between subtree launches it grows a table whose misses
look like conflict pressure (low hit rate at high occupancy) while total
slots stay within ``budget``, and shrinks tables whose occupancy stays low.
Resizing rehashes resident entries into the new table with one batched
insert.

**Payload region** (``cache_payloads=True``; evaluation-mode replay on
hit).  Besides its subtree count, an entry may own a factorized row
*block*: ``pay_off``/``pay_len`` metadata planes point into a per-node
slab arena (``payload_rows`` rows of the subtree's width).  Blocks are
bump-allocated on the host; blocks whose keys are evicted become dead
space until the arena wraps, at which point every payload is invalidated
in one epoch *flush* (keys and counts stay resident).  A payload-bearing
hit requires ``pay_len >= 0``; the metadata planes ride :func:`_insert`'s
election (its ``pay`` planes) on every insert, with count-mode inserts
writing the ``-1`` sentinel, so an evicting write can never leave a stale
block reachable under a new key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.registry import path_of
from ..kernels.tier2 import cuda as tier2_cuda, plain as tier2_plain
from .hostsync import device_get

POLICIES = ("direct", "setassoc", "costaware")

_hash_sets = tier2_plain.hash_sets


@dataclass(frozen=True)
class CacheConfig:
    """Tier-2 cache knobs.

    * ``policy``: "direct" | "setassoc" | "costaware".
    * ``slots``: initial entries per node table (0 disables tier 2).
    * ``assoc``: ways per set (ignored for "direct", which is 1-way).
    * ``dynamic``: enable the sizing controller.
    * ``budget``: max total slots summed over all node tables (None = only
      bounded by ``max_slots`` per table); also the dynamic controller's
      growth headroom.  Floor: every cached node keeps at least one set.
    * ``min_slots``/``max_slots``: per-table resize clamps.
    * ``resize_interval``: subtree launches between controller decisions.
    * ``grow_below_hit_rate``: grow when window hit-rate is below this and
      the table looks conflict-bound (occupancy > 1/2).
    * ``shrink_below_occupancy``: shrink when occupancy stays under this.
    * ``enabled_nodes``: restrict caching to these TD nodes (None = all).
    * ``cache_payloads``: additionally store factorized row *blocks* per
      entry (evaluation-mode replay on hit).
    * ``payload_rows``: per-node slab arena size in rows.
    * ``payload_throttle_probes`` / ``payload_throttle_hit_rate``: the
      store throttle: after that many evaluation probes a table whose
      payload hit rate is still below the floor stops *storing* new
      blocks (splicing stored blocks, and storing again once the rate
      recovers, are unaffected).
    * ``payload_probation``: while throttled, still store on every Nth
      throttled fold (0 disables), so a workload shift can re-open
      storage.
    """

    policy: str = "direct"
    slots: int = 1 << 16
    assoc: int = 4
    dynamic: bool = False
    budget: Optional[int] = None
    min_slots: int = 1 << 8
    max_slots: int = 1 << 22
    resize_interval: int = 8
    grow_below_hit_rate: float = 0.5
    shrink_below_occupancy: float = 0.125
    enabled_nodes: Optional[frozenset] = None
    cache_payloads: bool = False
    payload_rows: int = 1 << 15
    payload_throttle_probes: int = 1 << 15
    payload_throttle_hit_rate: float = 0.01
    payload_probation: int = 16

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown cache policy {self.policy!r}; "
                             f"expected one of {POLICIES}")
        if self.assoc < 1:
            raise ValueError("assoc must be >= 1")
        if self.cache_payloads and self.payload_rows < 1:
            raise ValueError("cache_payloads needs payload_rows >= 1")

    @property
    def ways(self) -> int:
        return 1 if self.policy == "direct" else int(self.assoc)

    def initial_slots(self) -> int:
        s = int(self.slots)
        if self.budget is not None:
            s = min(s, int(self.budget))
        if s <= 0:
            return 0
        # whole sets only; a positive request below one set rounds UP to a
        # single set rather than silently disabling the cache
        w = self.ways
        return max(w, (s // w) * w)


# ---------------------------------------------------------------------------
# Table ops.  Tables are (S, W) tensors: S sets, W ways.
# ---------------------------------------------------------------------------


def _probe(tkeys, tvals, tused, tstamp, keys, active, tick: int):
    """Batched lookup; returns (hit, vals, stamp') — stamp' records the LRU
    touch of every hit way (scatter-max, so duplicate rows are harmless).

    A CUDA chunk launches ``ctj_tier2_probe`` (``kernels/tier2/cuda.py``),
    a CPU chunk runs the op chain of ``kernels/tier2/plain.py``: the same
    results, bit for bit."""
    if path_of(keys) == "cuda":
        return tier2_cuda.probe(tkeys, tvals, tused, tstamp, keys, active,
                                tick)
    return tier2_plain.probe(tkeys, tvals, tused, tstamp, keys, active, tick)


def _insert(tkeys, tvals, tused, tstamp, tcost, keys, vals, costs, active,
            tick: int, *, policy: str, rounds: int = 1, pay=None):
    """Batched fill.  Victim selection per policy.

    Each round elects exactly one writer per set (the highest admitted row
    index) and writes it into its victim way.  ``rounds`` (≈ the way
    count) re-reads the updated table so batch collisions retry into the
    remaining ways instead of being dropped.

    ``pay`` (``None`` or ``(tpoff, tplen, poff, plen)``) carries the
    payload metadata planes through the same election, with two rules:

    * every admitted write also writes ``(poff, plen)`` — count-mode
      inserts pass the ``plen = -1`` sentinel, so an eviction can never
      leave the victim's block reachable under the new key;
    * a resident key only blocks re-admission when it already carries a
      payload (or the candidate has none): a payload-bearing candidate
      refreshes its resident way in place.

    Returns the new tables (the inputs are not modified), then — with
    ``pay`` — the new ``(tpoff, tplen)``, then the admit and evict counts
    (0-d int32).  A CUDA chunk launches ``ctj_tier2_insert`` (two kernels
    a round whose work follows the rows still remaining), a CPU chunk runs
    the op chain of ``kernels/tier2/plain.py`` over all C rows: the same
    results, bit for bit.
    """
    if path_of(keys) == "cuda":
        i64, i32 = torch.int64, torch.int32
        if pay is not None:
            tpoff, tplen, poff, plen = pay
            pay = (tpoff, tplen, poff.to(i32), plen.to(i32))
        return tier2_cuda.insert(tkeys, tvals, tused, tstamp, tcost, keys,
                                 vals.to(i64), costs.to(i64), active, tick,
                                 policy=policy, rounds=rounds, pay=pay)
    return tier2_plain.insert(tkeys, tvals, tused, tstamp, tcost, keys, vals,
                              costs, active, tick, policy=policy,
                              rounds=rounds, pay=pay)


def _probe_payload(tkeys, tused, tstamp, tpoff, tplen, keys, active,
                   tick: int):
    """Evaluation-mode lookup: a hit additionally requires a resident row
    block (``pay_len >= 0``) — entries inserted count-only are misses
    here.  Returns (hit, poff, plen, stamp'); dispatched as
    :func:`_probe`."""
    if path_of(keys) == "cuda":
        return tier2_cuda.probe_payload(tkeys, tused, tstamp, tpoff, tplen,
                                        keys, active, tick)
    return tier2_plain.probe_payload(tkeys, tused, tstamp, tpoff, tplen, keys,
                                     active, tick)


# ---------------------------------------------------------------------------


@dataclass
class DeviceCache:
    """One node's table: device tensors + deferred stats/controller.

    Stats are accumulated *on device* (the ``_acc_*`` fields hold lazy
    scalars) so probing/inserting never forces a host sync on the hot
    path; :meth:`stats` fetches them once, through the :mod:`hostsync`
    funnel, when actually read."""

    config: CacheConfig
    keys: torch.Tensor    # (S, W) int64
    vals: torch.Tensor    # (S, W) int64
    used: torch.Tensor    # (S, W) bool
    stamp: torch.Tensor   # (S, W) int32  — LRU clock (ticks)
    cost: torch.Tensor    # (S, W) int64  — recomputation-cost proxy
    # payload region (None unless config.cache_payloads)
    pay_off: Optional[torch.Tensor] = None  # (S, W) int32 — slab offset
    pay_len: Optional[torch.Tensor] = None  # (S, W) int32 — rows; -1 = none
    slab: Optional[torch.Tensor] = None     # (payload_rows + 1, width)
    #                                         int32; last row = scratch
    slab_bump: int = 0                      # host-side arena bump pointer
    payload_flushes: int = 0
    payload_skips: int = 0                  # eligible blocks not stored
    payload_throttled: int = 0              # folds skipped by the throttle
    # host-side evaluation-probe counters feeding the store throttle (the
    # executor feeds them from its per-fold planning fetch: no extra sync)
    eval_probes_h: int = 0
    eval_hits_h: int = 0
    tick: int = 0
    resizes: int = 0
    window_launches: int = 0
    # device-side accumulators (int until the first op touches them)
    _acc_hits: object = 0
    _acc_misses: object = 0
    _acc_probes: object = 0
    _acc_inserts: object = 0
    _acc_evictions: object = 0
    _acc_payload_hits: object = 0
    # sliding window consumed by the sizing controller
    _acc_window_hits: object = 0
    _acc_window_probes: object = 0

    @staticmethod
    def create(config: CacheConfig, slots: Optional[int] = None, *,
               device) -> "DeviceCache":
        n = config.initial_slots() if slots is None else int(slots)
        w = config.ways
        s = max(1, n // w)

        def z(dtype):
            return torch.zeros((s, w), dtype=dtype, device=device)

        pay_off = pay_len = None
        if config.cache_payloads:
            pay_off = z(torch.int32)
            pay_len = torch.full((s, w), -1, dtype=torch.int32,
                                 device=device)
        return DeviceCache(config=config, keys=z(torch.int64),
                           vals=z(torch.int64), used=z(torch.bool),
                           stamp=z(torch.int32), cost=z(torch.int64),
                           pay_off=pay_off, pay_len=pay_len)

    # -- capacity ------------------------------------------------------
    @property
    def n_slots(self) -> int:
        return int(self.keys.shape[0] * self.keys.shape[1])

    def occupancy(self) -> int:
        return int(device_get(self.used.sum(), "cache-occupancy"))

    # -- ops -----------------------------------------------------------
    def _account(self, active: torch.Tensor,
                 hit: torch.Tensor) -> torch.Tensor:
        """Device-side probe accounting (no host sync on the probe path);
        returns the hit count."""
        n_active = active.sum(dtype=torch.int64)
        n_hit = hit.sum(dtype=torch.int64)
        self._acc_probes = self._acc_probes + n_active
        self._acc_hits = self._acc_hits + n_hit
        self._acc_misses = self._acc_misses + (n_active - n_hit)
        self._acc_window_probes = self._acc_window_probes + n_active
        self._acc_window_hits = self._acc_window_hits + n_hit
        return n_hit

    def probe(self, qkeys: torch.Tensor,
              active: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        self.tick += 1
        hit, vals, self.stamp = _probe(self.keys, self.vals, self.used,
                                       self.stamp, qkeys, active, self.tick)
        self._account(active, hit)
        return hit, vals

    def probe_payload(self, qkeys: torch.Tensor, active: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Evaluation-mode lookup: hit only on entries with a resident row
        block; returns (hit, slab offset, block length)."""
        if self.pay_off is None:
            raise ValueError("probe_payload needs cache_payloads=True")
        self.tick += 1
        hit, poff, plen, self.stamp = _probe_payload(
            self.keys, self.used, self.stamp, self.pay_off, self.pay_len,
            qkeys, active, self.tick)
        n_hit = self._account(active, hit)
        self._acc_payload_hits = self._acc_payload_hits + n_hit
        return hit, poff, plen

    def insert(self, qkeys: torch.Tensor, vals: torch.Tensor,
               active: torch.Tensor,
               costs: Optional[torch.Tensor] = None,
               poff: Optional[torch.Tensor] = None,
               plen: Optional[torch.Tensor] = None) -> None:
        self.tick += 1
        if costs is None:  # default proxy: the count itself (clipped >= 1)
            costs = vals.clamp(min=1)
        kw = dict(policy=self.config.policy, rounds=min(self.config.ways, 8))
        args = (self.keys, self.vals, self.used, self.stamp, self.cost,
                qkeys, vals, costs.to(torch.int64), active, self.tick)
        if self.pay_off is not None:
            # payload tables carry the metadata planes through EVERY
            # insert so evicting writes always overwrite them (count
            # inserts carry the -1 sentinel — never a stale block)
            if poff is None:
                poff = torch.zeros_like(qkeys, dtype=torch.int32)
                plen = torch.full_like(qkeys, -1, dtype=torch.int32)
            (self.keys, self.vals, self.used, self.stamp, self.cost,
             self.pay_off, self.pay_len, n_ins, n_evict) = _insert(
                *args, pay=(self.pay_off, self.pay_len, poff, plen), **kw)
        else:
            (self.keys, self.vals, self.used, self.stamp, self.cost, n_ins,
             n_evict) = _insert(*args, **kw)
        self._acc_inserts = self._acc_inserts + n_ins
        self._acc_evictions = self._acc_evictions + n_evict
        self.window_launches += 1

    # -- payload slab arena --------------------------------------------
    def ensure_slab(self, width: int) -> None:
        """Lazily allocate the block arena: ``payload_rows`` rows of the
        node's subtree width, plus one scratch row for masked writes."""
        if self.slab is None:
            self.slab = torch.zeros(
                (int(self.config.payload_rows) + 1, width),
                dtype=torch.int32, device=self.keys.device)
        elif self.slab.shape[1] != width:
            raise ValueError(
                f"slab width {self.slab.shape[1]} != subtree width {width}")

    def alloc_blocks(self, lens: np.ndarray, active: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side bump allocation of one batch of variable-length blocks.

        ``lens[i]`` rows are requested for candidate row ``i`` (``active``
        masks real candidates).  Blocks larger than the whole arena are
        refused outright.  If the rest of the batch does not fit the
        remaining arena, the arena is *flushed* first (every payload
        invalidated — keys/counts stay resident); candidates still beyond
        capacity are refused prefix-wise.  Returns ``(offsets, admitted)``
        (numpy, host) — refusals only cost future recomputation.
        """
        cap = int(self.config.payload_rows)
        lens = np.where(active, np.asarray(lens, np.int64), 0)
        lens = np.where(lens <= cap, lens, 0)  # can never fit: refuse
        total = int(lens.sum())
        if total > cap - self.slab_bump and self.slab_bump > 0 and total:
            self.flush_payloads()
        cum = np.cumsum(lens)
        admit = (lens > 0) & (cum <= cap - self.slab_bump)
        offs = np.where(admit, self.slab_bump + cum - lens, 0).astype(
            np.int32)
        if admit.any():
            self.slab_bump += int(lens[admit].sum())
        return offs, admit

    def note_eval_probes(self, probes: int, hits: int) -> None:
        """Feed the store throttle (host counters, no device sync).  The
        counters halve past 4x the probe floor — a sliding window, so a
        miss-heavy prefix cannot latch the throttle."""
        self.eval_probes_h += int(probes)
        self.eval_hits_h += int(hits)
        if self.eval_probes_h > 4 * self.config.payload_throttle_probes:
            self.eval_probes_h //= 2
            self.eval_hits_h //= 2

    def store_throttled(self) -> bool:
        """True once this table has seen many evaluation probes at a
        negligible payload hit rate: storing more blocks is then pure
        overhead."""
        cfg = self.config
        return (self.eval_probes_h >= cfg.payload_throttle_probes
                and self.eval_hits_h
                < cfg.payload_throttle_hit_rate * self.eval_probes_h)

    def flush_payloads(self) -> None:
        """Epoch reset of the arena: every payload pointer is invalidated
        (keys and counts stay) and the bump pointer rewinds."""
        if self.pay_len is not None:
            self.pay_len = torch.full_like(self.pay_len, -1)
        self.slab_bump = 0
        self.payload_flushes += 1

    # -- dynamic sizing (the paper's flexible-cache knob) --------------
    def maybe_resize(self, headroom: Optional[int] = None) -> int:
        """Controller step; returns the slot delta (0 = no change).

        Grow ×2 when the window hit-rate is low *and* the table is mostly
        full (conflict pressure — more slots can actually help); shrink ÷2
        when occupancy stays below the configured floor (memory handed
        back).  ``headroom`` caps growth (global budget minus slots already
        spent elsewhere)."""
        cfg = self.config
        if not cfg.dynamic or self.window_launches < cfg.resize_interval:
            return 0
        probes, hits = (int(x) for x in device_get(
            (self._acc_window_probes, self._acc_window_hits),
            "cache-resize-window"))
        self._acc_window_hits = self._acc_window_probes = 0
        self.window_launches = 0
        if probes == 0:
            return 0
        hit_rate = hits / probes
        occ = self.occupancy() / max(1, self.n_slots)
        old = self.n_slots
        new = old
        if (hit_rate < cfg.grow_below_hit_rate and occ > 0.5
                and old * 2 <= cfg.max_slots):
            new = old * 2
            if headroom is not None:
                new = min(new, old + max(0, headroom))
        elif occ < cfg.shrink_below_occupancy and old // 2 >= cfg.min_slots:
            new = old // 2
        new = (new // cfg.ways) * cfg.ways
        if new <= 0 or new == old:
            return 0
        self._rehash(new)
        self.resizes += 1
        return self.n_slots - old

    def _rehash(self, new_slots: int) -> None:
        old = (self.keys.reshape(-1), self.vals.reshape(-1),
               self.cost.reshape(-1), self.used.reshape(-1))
        old_pay = (None if self.pay_off is None else
                   (self.pay_off.reshape(-1), self.pay_len.reshape(-1)))
        fresh = DeviceCache.create(self.config, new_slots,
                                   device=self.keys.device)
        self.keys, self.vals, self.used, self.stamp, self.cost = (
            fresh.keys, fresh.vals, fresh.used, fresh.stamp, fresh.cost)
        self.pay_off, self.pay_len = fresh.pay_off, fresh.pay_len
        # the slab and its bump pointer survive a resize: offsets carried
        # in the re-inserted metadata still point at live arena rows
        if not bool(device_get(old[3].any(), "cache-rehash")):
            return
        # re-insert resident entries in one batched op; rehash collisions
        # drop entries, which only costs future recomputation (optionality)
        self.tick += 1
        old_keys, old_vals, old_cost, old_used = old
        kw = dict(policy=self.config.policy, rounds=min(self.config.ways, 8))
        args = (self.keys, self.vals, self.used, self.stamp, self.cost,
                old_keys, old_vals, old_cost, old_used, self.tick)
        if old_pay is not None:
            out = _insert(*args, pay=(self.pay_off, self.pay_len) + old_pay,
                          **kw)
            self.pay_off, self.pay_len = out[5:7]
        else:
            out = _insert(*args, **kw)
        self.keys, self.vals, self.used, self.stamp, self.cost = out[:5]

    def stats(self) -> Dict[str, int]:
        acc = device_get(
            {"hits": self._acc_hits, "misses": self._acc_misses,
             "probes": self._acc_probes, "inserts": self._acc_inserts,
             "evictions": self._acc_evictions,
             "payload_hits": self._acc_payload_hits,
             "occupancy": self.used.sum()}, "cache-stats")
        out = {k: int(v) for k, v in acc.items()}
        out["resizes"] = self.resizes
        out["slots"] = self.n_slots
        out["payload_flushes"] = self.payload_flushes
        out["payload_skips"] = self.payload_skips
        out["payload_throttled"] = self.payload_throttled
        out["slab_rows"] = self.slab_bump
        return out

    # -- cross-process state (serving snapshots) -----------------------
    def export_state(self) -> Dict[str, object]:
        """Host copy of everything a fresh process needs to serve hits
        from this table: the key/count planes, the payload metadata and
        slab arena, and the host-side slab epoch (``slab_bump`` and
        ``payload_flushes``) with the LRU ``tick``.  Without the epoch a
        loader's allocator would restart at row 0 and overwrite resident
        blocks whose ``pay_off``/``pay_len`` still claim those rows (stale
        splices).  One ``cache-export`` fetch."""
        arrays = {"keys": self.keys, "vals": self.vals, "used": self.used,
                  "stamp": self.stamp, "cost": self.cost}
        if self.pay_off is not None:
            arrays["pay_off"] = self.pay_off
            arrays["pay_len"] = self.pay_len
            if self.slab is not None:
                arrays["slab"] = self.slab
        state: Dict[str, object] = dict(device_get(arrays, "cache-export"))
        state["slab_bump"] = int(self.slab_bump)
        state["payload_flushes"] = int(self.payload_flushes)
        state["tick"] = int(self.tick)
        return state

    def import_state(self, state: Dict[str, object]) -> str:
        """Adopt an exported table state (this port's or the reference's
        ``export_state()``).  Returns:

        * ``"ok"``       — keys/counts and (if configured) payloads resident;
        * ``"flushed"``  — keys/counts adopted but the payload region was
          cold-started because the state's slab epoch is unusable
          (missing or mis-shaped slab, or a resident block outside
          ``[0, slab_bump]``: a later allocation would overwrite rows a key
          still points at);
        * ``"rejected"`` — state malformed for this config; table unchanged.

        The slot count may differ from ``config.slots`` (the writer may
        have resized): the table's geometry follows the planes' shape."""
        try:
            keys = np.asarray(state["keys"], np.int64)
            vals = np.asarray(state["vals"], np.int64)
            used = np.asarray(state["used"], bool)
            stamp = np.asarray(state["stamp"], np.int32)
            cost = np.asarray(state["cost"], np.int64)
        except (KeyError, TypeError, ValueError):
            return "rejected"
        shape = keys.shape
        if (keys.ndim != 2 or shape[1] != self.config.ways
                or any(a.shape != shape
                       for a in (vals, used, stamp, cost))):
            return "rejected"
        dev = self.keys.device

        def t(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.array(a)).to(dev)  # a writable copy

        self.keys, self.vals, self.used, self.stamp, self.cost = (
            t(keys), t(vals), t(used), t(stamp), t(cost))
        self.tick = max(self.tick, int(state.get("tick", 0)))
        if not self.config.cache_payloads:
            return "ok"
        cap = int(self.config.payload_rows)
        try:
            pay_off = np.asarray(state["pay_off"], np.int32)
            pay_len = np.asarray(state["pay_len"], np.int32)
            bump = int(state["slab_bump"])
            if pay_off.shape != shape or pay_len.shape != shape:
                raise ValueError("payload plane shape mismatch")
            resident = used & (pay_len >= 0)
            if not 0 <= bump <= cap:
                raise ValueError("slab_bump outside the arena")
            if "slab" in state:
                slab = np.asarray(state["slab"], np.int32)
                if slab.ndim != 2 or slab.shape[0] != cap + 1:
                    raise ValueError("slab arena shape mismatch")
            elif resident.any() or bump != 0:
                # the writer never allocated an arena: legal only if no
                # entry claims a block
                raise ValueError("resident blocks but no slab arena")
            else:
                slab = None
            off = pay_off[resident].astype(np.int64)
            ln = pay_len[resident].astype(np.int64)
            # the slab-epoch invariant: every resident block lies inside
            # the allocated prefix, else a later allocation would
            # overwrite rows a key still points at
            if (off < 0).any() or (off + ln > bump).any():
                raise ValueError("resident block outside the slab epoch")
        except (KeyError, TypeError, ValueError):
            # cold-start the payload region only: keys and counts stay
            # warm, blocks fill again on use
            self.pay_off = torch.zeros(shape, dtype=torch.int32, device=dev)
            self.pay_len = torch.full(shape, -1, dtype=torch.int32,
                                      device=dev)
            self.slab = None
            self.slab_bump = 0
            self.payload_flushes += 1
            return "flushed"
        self.pay_off, self.pay_len = t(pay_off), t(pay_len)
        self.slab = None if slab is None else t(slab)
        self.slab_bump = bump
        self.payload_flushes = int(state.get("payload_flushes", 0))
        return "ok"


class CacheManager:
    """Per-TD-node DeviceCaches under one global slot budget."""

    def __init__(self, config: CacheConfig, *, device):
        self.config = config
        self.device = torch.device(device)
        self.tables: Dict[int, DeviceCache] = {}
        # engine hint: how many node tables will eventually exist, so the
        # controller reserves their initial allocations out of the budget
        # instead of letting the first-created table grow into all of it
        self.expected_tables: Optional[int] = None

    @property
    def enabled(self) -> bool:
        return self.config.initial_slots() > 0

    def node_enabled(self, v: int) -> bool:
        en = self.config.enabled_nodes
        return self.enabled and (en is None or v in en)

    def get(self, v: int) -> DeviceCache:
        t = self.tables.get(v)
        if t is None:
            slots = self.config.initial_slots()
            if self.config.budget is not None:
                # node tables are created lazily: cap a newcomer by the
                # remaining headroom so earlier growth cannot spend the
                # whole budget (floor: one set, so the node still caches)
                headroom = self.config.budget - self.total_slots()
                slots = min(slots, max(self.config.ways, headroom))
            t = DeviceCache.create(self.config, slots, device=self.device)
            self.tables[v] = t
        return t

    def total_slots(self) -> int:
        return sum(t.n_slots for t in self.tables.values())

    def maybe_resize(self, v: int) -> int:
        t = self.tables.get(v)
        if t is None:
            return 0
        headroom = None
        if self.config.budget is not None:
            headroom = self.config.budget - self.total_slots()
            if self.expected_tables is not None:
                missing = max(0, self.expected_tables - len(self.tables))
                headroom -= missing * self.config.initial_slots()
        return t.maybe_resize(headroom)

    def stats(self) -> Dict[str, int]:
        agg = {"hits": 0, "misses": 0, "probes": 0, "inserts": 0,
               "evictions": 0, "resizes": 0, "slots": 0, "occupancy": 0,
               "payload_hits": 0, "payload_flushes": 0, "payload_skips": 0,
               "payload_throttled": 0, "slab_rows": 0}
        for t in self.tables.values():
            for k, val in t.stats().items():
                agg[k] = agg.get(k, 0) + val
        return agg

    # -- cross-process state (serving snapshots) -----------------------
    def export_state(self) -> Dict[int, Dict[str, object]]:
        """Per-node table states (see :meth:`DeviceCache.export_state`)."""
        return {int(v): t.export_state() for v, t in self.tables.items()}

    def import_state(self, states: Dict[int, Dict[str, object]]
                     ) -> Dict[int, str]:
        """Adopt exported per-node states; nodes disabled under this
        config are skipped.  Returns each node's status (``"ok"`` /
        ``"flushed"`` / ``"rejected"``, see
        :meth:`DeviceCache.import_state`, or ``"skipped"``)."""
        out: Dict[int, str] = {}
        for v, st in states.items():
            v = int(v)
            out[v] = (self.get(v).import_state(st) if self.node_enabled(v)
                      else "skipped")
        return out
