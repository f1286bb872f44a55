"""The cached trie join's core.

Layers:
  * planning  — cq / gaifman / td / separators / decompose (paper §2, §4)
  * data      — db
  * host      — trie / lftj_ref / clftj_ref / yannakakis / bruteforce (the
                paper's host engines, Figs 1-2 and §5.1, and the oracle)
  * engine    — frontier / cached_frontier / schedule / cache / hostsync
  * static    — distributed (StaticCLFTJ: the fixed-capacity pass, and
                its count / evaluation split over a process group)
  * facade    — engine.count / engine.evaluate / engine.evaluate_stream /
                engine.serve / engine.plan_query

Reference: ``repro/core/__init__.py``.
"""
from .cq import (CQ, Atom, bowtie_query, cq, path_query, cycle_query,
                 clique_query, lollipop_query, random_graph_query,
                 star_query, two_relation_cycle_query)
from .db import Counters, Database, graph_db
from .td import TreeDecomposition, singleton_td
from .decompose import choose_plan, enumerate_tds, DBStats
from .clftj_ref import (CLFTJ, CachePolicy, Plan, clftj_count,
                        clftj_evaluate)
from .lftj_ref import LFTJ, lftj_count, lftj_evaluate
from .yannakakis import YTD, ytd_count, ytd_evaluate
from .cache import CacheConfig, CacheManager, DeviceCache
from .hostsync import SyncCounter, device_get
from .schedule import Op, Schedule, ScheduleExecutor, execute_static, lower
from .frontier import Frontier, TrieJoin
from .cached_frontier import CachedTrieJoin
from .distributed import (StaticCLFTJ, make_distributed_count,
                          make_distributed_evaluate)
from . import engine
