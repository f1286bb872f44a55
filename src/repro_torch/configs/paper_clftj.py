"""The paper's artifact: CLFTJ join-engine configuration presets.

The counterpart of the reference's ``repro/configs/paper_clftj.py``, with
its fields: planning (the adhesion-dimension cap — the paper's hash maps
take at most 2 key attributes — and the TD-enumeration budget, §4.3), the
host CLFTJ's cache (the §3.4 admission threshold ``support_threshold``,
Fig 10's bound ``capacity`` and its ``evict`` flavour, read through
:meth:`JoinEngineConfig.host_policy`), the frontier capacity, tier-1
dedup, the tier-2 device cache (policy, associativity, slots, sizing
controller, payload replay), the streaming-emit window, and the kernel
paths: ``expand_kernel``, ``fold_kernel`` and ``emit_kernel`` (each
``"fused"`` | ``"chain"``) with the chain EXPAND's bounded search
``impl`` (``"bsearch"`` | ``"leapfrog"``).  The presets are the
reference's, named for the card: ``GPU_*`` for ``TPU_*``.
``GPU_FUSED_EXPAND``, the reference's ``TPU_FUSED_EXPAND``, equals the
port's default (the fused kernels run whenever the chunk is on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.cache import CacheConfig
from ..core.clftj_ref import CachePolicy

__all__ = ["JoinEngineConfig", "PAPER_FAITHFUL", "BOUNDED_100K",
           "GPU_DEFAULT", "GPU_SETASSOC", "GPU_COST_AWARE", "GPU_ADAPTIVE",
           "GPU_EVAL_REPLAY", "GPU_FUSED_EXPAND", "GPU_STREAM_EMIT",
           "GPU_SERVE"]


@dataclass(frozen=True)
class JoinEngineConfig:
    # planning (paper §4)
    max_adhesion: int = 2          # separator-size bound in TD enumeration
    td_limit: int = 24             # TDs scored before picking one
    # the host CLFTJ (paper Fig 2; engine backend="ref")
    support_threshold: int = 1     # §3.4 admission policy
    capacity: Optional[int] = None  # Fig 10 cache bound (None = unbounded)
    evict: str = "none"            # none | lru | cost
    # the frontier engine
    frontier_capacity: int = 1 << 16
    cache_slots: int = 1 << 16     # tier-2 table slots (initial)
    cache_policy: str = "direct"   # direct | setassoc | costaware
    cache_assoc: int = 4           # ways per set (setassoc/costaware)
    cache_dynamic: bool = False    # sizing controller on/off
    cache_budget: Optional[int] = None  # max total slots across node tables
    cache_payloads: bool = False   # evaluation-mode row-block replay
    payload_rows: int = 1 << 15    # slab arena rows per node table
    dedup: bool = True             # tier-1 intra-chunk dedup
    impl: str = "bsearch"          # bsearch | leapfrog (the chain's search)
    expand_kernel: str = "fused"   # fused | chain
    fold_kernel: str = "fused"     # fused | chain
    emit_kernel: str = "fused"     # fused | chain
    emit_in_flight: int = 8        # streaming-emit async-copy bound

    def host_policy(self) -> CachePolicy:
        """The host CLFTJ's cache policy (``engine.count(...,
        backend="ref", policy=cfg.host_policy())``)."""
        return CachePolicy(support_threshold=self.support_threshold,
                           capacity=self.capacity, evict=self.evict)

    def cache_config(self) -> CacheConfig:
        """Tier-2 device-cache config of the frontier engine."""
        return CacheConfig(policy=self.cache_policy, slots=self.cache_slots,
                           assoc=self.cache_assoc, dynamic=self.cache_dynamic,
                           budget=self.cache_budget,
                           cache_payloads=self.cache_payloads,
                           payload_rows=self.payload_rows)


PAPER_FAITHFUL = JoinEngineConfig(
    # "We first consider caches that store every intermediate result" (§5.1)
    support_threshold=1, capacity=None)
BOUNDED_100K = JoinEngineConfig(capacity=100_000)   # Fig 10 mid-point
GPU_DEFAULT = JoinEngineConfig()

# flexible-cache presets (the tier-2 policy sweep)
GPU_SETASSOC = JoinEngineConfig(cache_policy="setassoc", cache_assoc=4)
GPU_COST_AWARE = JoinEngineConfig(cache_policy="costaware", cache_assoc=4)
GPU_ADAPTIVE = JoinEngineConfig(      # Fig 10's size knob made adaptive
    cache_policy="setassoc", cache_assoc=4, cache_slots=1 << 10,
    cache_dynamic=True, cache_budget=1 << 18)
GPU_EVAL_REPLAY = JoinEngineConfig(   # §3.4 evaluation: replay on hit
    cache_policy="setassoc", cache_assoc=8, cache_slots=1 << 14,
    cache_payloads=True, payload_rows=1 << 17)
GPU_FUSED_EXPAND = JoinEngineConfig(  # every op on its kernel: EXPAND,
    # FOLD and EMIT one launch each (the default)
    expand_kernel="fused", fold_kernel="fused", emit_kernel="fused")
GPU_STREAM_EMIT = JoinEngineConfig(   # streaming evaluation: replay-capable
    # tier 2 and a deeper async-emit window
    cache_policy="setassoc", cache_assoc=8, cache_slots=1 << 14,
    cache_payloads=True, payload_rows=1 << 17, emit_in_flight=16)
GPU_SERVE = JoinEngineConfig(         # the serving layer's default: long-
    # lived engines answering many queries — associative tables so keys of
    # different queries do not thrash one slot, payload replay so warm
    # queries splice instead of recomputing, streaming emit for sessions
    cache_policy="setassoc", cache_assoc=8, cache_slots=1 << 14,
    cache_payloads=True, payload_rows=1 << 17, emit_in_flight=8)
