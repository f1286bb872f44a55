"""Dry-run of the paper's technique itself: the distributed count on the
production meshes' rank counts, with one rank's shard run for real.

The counterpart of the reference's ``repro/launch/dryrun_join.py``, which
lowers the distributed CLFTJ (shard_map over candidate runs, private
caches, one psum) on 256 or 512 forced host devices and reports its
memory and cost analysis.  Here one process joins a fake process group
of 256 or 512 ranks (``dryrun.fake_group``) as rank 0 and builds
``core/distributed.py::make_distributed_count`` on it, with the
reference's inputs (``barabasi_albert(4000, 8, seed=11)``, the 5-cycle
or the 5-path, capacity 2^14, a direct cache of 2^15 slots); ``fn()``
then runs rank 0's shard, a real static pass on ``device`` (the card by
default), and its one ``all_reduce`` of the (count, overflow) sums.  A
fake group's ``all_reduce`` moves nothing: the count recorded is rank
0's shard (``count_is`` says so), not the sum over the ranks.  A record
holds that count and overflow, the pass's seconds, the device's peak
bytes over the pass (CUDA; ``None`` on the CPU: not measured), the
bytes of the shard's tier-2 tables and of one frontier chunk, and the
collective bytes the pass issued (``costprobe``'s counts of the
``c10d`` ops: the result's bytes, the all-reduce weighted 2x as in
``roofline.weighted_collective_bytes``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_join --out dryrun_join.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun_join --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from ..core import CacheConfig, choose_plan, cycle_query, path_query
from ..core.db import graph_db
from ..core.distributed import make_distributed_count
from ..data.graphs import barabasi_albert
from . import roofline as rl
from .dryrun import fake_group


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def join_inputs(query: str = "5-cycle", graph=(4000, 8, 11)):
    """(query, database, TD, order) of a dry-run record: the reference's
    Barabási-Albert graph (n, edges a node, seed) and its plan."""
    n, m, seed = graph
    db = graph_db(barabasi_albert(n, m, seed=seed))
    q = cycle_query(5) if query == "5-cycle" else path_query(5)
    td, order = choose_plan(q, db.stats())
    return q, db, td, order


def run_join(multi_pod: bool = False, capacity: int = 1 << 14,
             cache_slots: int = 1 << 15, query: str = "5-cycle",
             device: str = "cuda", world: Optional[int] = None,
             graph=(4000, 8, 11)) -> dict:
    """The record of rank 0 of ``world`` (256, or 512 with
    ``multi_pod``, by default) ranks: its shard's pass on ``device``."""
    import torch.distributed as dist
    from .costprobe import RankCounts
    world = world or (512 if multi_pod else 256)
    q, db, td, order = join_inputs(query, graph)
    fake_group(world)
    try:
        fn, eng = make_distributed_count(
            q, td, order, db, capacity=capacity,
            cache=CacheConfig(policy="direct", slots=cache_slots),
            device=device)
        tables = _bytes(t for tab in eng.make_tables("count").values()
                        for t in tab)
        frontier = _bytes(eng.initial_frontier())
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        counts = RankCounts(collectives_only=True)
        t0 = time.perf_counter()
        with counts:
            count, overflow = fn()
            count, overflow = int(count), int(overflow)
        pass_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else None
    finally:
        dist.destroy_process_group()
    return {
        "kind": "join_engine", "query": query,
        "mesh": "multi" if multi_pod else "single",
        "n_devices": world, "capacity": capacity,
        "cache_slots": cache_slots, "device": str(device),
        "status": "ok",
        "shard_count": count, "shard_overflow": bool(overflow),
        "count_is": "rank 0's shard (a fake group's all_reduce moves "
                    "nothing: not the sum over the ranks)",
        "pass_s": round(pass_s, 3),
        "memory": {"peak_device_bytes": peak, "table_bytes": tables,
                   "frontier_bytes": frontier},
        "collectives": dict(counts.per_op),
        "collective_bytes_weighted":
            rl.weighted_collective_bytes(counts.per_op),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dryrun_join.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    recs = []
    for mp in (False, True):
        for query in ("5-cycle", "5-path"):
            print(f"[dryrun-join] multi_pod={mp} {query} ...", flush=True)
            rec = run_join(mp, query=query, device=args.device)
            recs.append(rec)
            peak = rec["memory"]["peak_device_bytes"]
            print(f"  ok: rank 0 of {rec['n_devices']}: count "
                  f"{rec['shard_count']} in {rec['pass_s']} s  coll="
                  f"{rec['collective_bytes_weighted'] / 1e3:.3f} KB  "
                  f"tables={rec['memory']['table_bytes'] / 2 ** 20:.1f} MiB"
                  + (f"  peak={peak / 2 ** 20:.0f} MiB" if peak else ""),
                  flush=True)
            with open(args.out, "w") as f:
                json.dump(recs, f, indent=1)
    return recs


if __name__ == "__main__":
    main()
