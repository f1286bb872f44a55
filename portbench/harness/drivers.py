"""The program under test, driven through its public entry points.

Two entries, named by a traffic mix's ``"entry"``:

* ``"server"``: ``repro_torch.core.engine.serve(db, config)``, the
  ``JoinServer``; ``traffic["clients"]`` client threads in a closed loop,
  each submitting its next query (``submit(q, mode)``) only once its last
  one has returned its count or had its last block drained;
* ``"static_count"``: ``StaticCLFTJ.count_fn()`` over the engine's initial
  chunk, one pass after another, each pass with fresh tier-2 tables and
  ending in the host's read of its count.

Everything timed here is timed on the host's clock around work that ends
in a host copy of the answer, so no device work is left outside it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .graphs import rng
from .queries import Query, query_log, warmup_queries

__all__ = ["Record", "QueryLog", "Program", "open_program"]

RESULT_TIMEOUT_S = 240.0    # the longest a client waits for one answer


@dataclass
class Record:
    """One query as its client saw it.  Times are ``perf_counter`` s."""

    query: Query
    t_submit: float
    t_done: float = 0.0
    t_first: Optional[float] = None     # first block (streams)
    n: int = -1                         # the count, or the rows drained
    order: tuple = ()                   # the columns of ``rows``
    rows: Optional[np.ndarray] = None   # kept rows (sampled streams)
    result: object = None               # the program's Result, if any
    syncs: Optional[int] = None         # blocking device->host syncs
    overflow: bool = False
    error: Optional[str] = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


def _cq(q: Query, relation: str):
    from repro_torch.core.cq import CQ, Atom
    return CQ(tuple(Atom(relation, a) for a in q.atoms))


class QueryLog:
    """The mix's query log, drawn a stretch at a time, with each query's
    row-check flag: the first query of each shape in the window, and a
    share ``row_sample`` of the others drawn from the seed."""

    def __init__(self, traffic: dict, seed: int):
        self.traffic, self.seed = traffic, seed
        self.queries: List[Query] = []
        self.sampled = rng(seed, "sample")
        self.share = float(traffic.get("row_sample", 0.0))
        self.seen: set = set()
        self.taken = 0
        self.lock = threading.Lock()

    def take(self) -> tuple:
        """The next query and whether its rows are to be kept."""
        with self.lock:
            if self.taken >= len(self.queries):
                self.queries = query_log(self.traffic, self.seed,
                                         max(64, 2 * len(self.queries)))
            q = self.queries[self.taken]
            self.taken += 1
            keep = self.share > 0 and (q.shape not in self.seen
                                       or self.sampled.random() < self.share)
            self.seen.add(q.shape)
            return q, keep


class Program:
    """The program's state for one run: set up by :func:`open_program`,
    driven by :meth:`window`, freed by :meth:`close`."""

    def __init__(self, cell, db, device: str):
        import torch
        from repro_torch.configs.paper_clftj import GPU_SERVE
        self.cell, self.db, self.device = cell, db, torch.device(device)
        self.traffic = cell.traffic
        self.relation = cell.config.get("relation", "E")
        self.jcfg = dataclasses.replace(GPU_SERVE, **cell.config["engine"])
        self.server = None
        self.static = None
        self.warmup: List[Record] = []

    # -- set-up ------------------------------------------------------------
    def setup(self, seed: int) -> None:
        entry = self.traffic["entry"]
        if entry == "server":
            from repro_torch.core import engine
            srv_cfg = self.cell.config.get("server", {})
            self.server = engine.serve(
                self.db, config=self.jcfg, device=str(self.device),
                max_plans=int(srv_cfg.get("max_plans", 64)),
                max_sessions=int(srv_cfg.get("max_sessions", 8)))
            # a warm-up query that fails is counted with the window's
            # answers (``failed_queries``)
            keep = self.traffic.get("row_sample", 0) > 0
            self.warmup = [self._serve_one(q, keep)
                           for q in warmup_queries(self.traffic, seed)]
        elif entry == "static_count":
            from repro_torch.core import engine
            from repro_torch.core.distributed import StaticCLFTJ
            if len(self.traffic["queries"]) != 1:
                raise ValueError("a static mix runs one query shape")
            q = warmup_queries(self.traffic, seed)[0]
            cq = _cq(q, self.relation)
            td, order = engine.plan_query(cq, self.db)
            self.static_query = q
            self.static = StaticCLFTJ(
                cq, td, order, self.db,
                capacity=int(self.cell.config["static"]["frontier_capacity"]),
                cache=self.jcfg.cache_config(), device=self.device)
            self.static_fn = self.static.count_fn()
            self.warmup = [self._static_one()]
        else:
            raise ValueError(f"unknown traffic entry {entry!r}")
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    # -- one query ----------------------------------------------------------
    def _serve_one(self, q: Query, keep: bool) -> Record:
        mode = self.traffic["mode"]
        rec = Record(query=q, t_submit=time.perf_counter())
        try:
            sess = self.server.submit(_cq(q, self.relation), mode)
            if mode == "count":
                res = sess.result(timeout=RESULT_TIMEOUT_S)
                rec.n = int(res.count)
            else:
                n, kept = 0, []
                for block in sess.blocks():
                    if rec.t_first is None:
                        rec.t_first = time.perf_counter()
                    n += block.shape[0]
                    if keep:
                        kept.append(block)
                res = sess.result(timeout=RESULT_TIMEOUT_S)
                rec.n = n
                rec.order = tuple(sess.order)
                if keep:
                    rec.rows = (np.concatenate(kept) if kept else
                                np.zeros((0, len(q.names)), np.int32))
            rec.t_done = time.perf_counter()
            rec.result = res
            rec.syncs = sess.sync.count if sess.sync is not None else None
        except Exception as e:  # noqa: BLE001 — a failed query is counted
            rec.t_done = time.perf_counter()
            rec.error = f"{type(e).__name__}: {e}"
        return rec

    def _static_one(self) -> Record:
        rec = Record(query=self.static_query, t_submit=time.perf_counter())
        try:
            total, ov = self.static_fn(self.static.initial_frontier())
            rec.n, rec.overflow = int(total.item()), bool(ov.item())
            rec.t_done = time.perf_counter()
        except Exception as e:  # noqa: BLE001 — a failed pass is counted
            rec.t_done = time.perf_counter()
            rec.error = f"{type(e).__name__}: {e}"
        return rec

    # -- the window ---------------------------------------------------------
    def server_stats(self) -> Optional[dict]:
        return self.server.stats() if self.server is not None else None

    def window(self, seed: int, seconds: float) -> List[Record]:
        """Run the mix until ``seconds`` have passed since the call; every
        query started before then runs to its end.  Returns the queries
        in the order they completed."""
        t_end = time.perf_counter() + seconds
        done: List[Record] = []
        lock = threading.Lock()
        # a failed query ends its client's loop: the run is not correct
        # anyway, and a program that fails at once would spin
        if self.static is not None:
            while time.perf_counter() < t_end:
                done.append(self._static_one())
                if done[-1].error is not None:
                    break
            return done
        log = QueryLog(self.traffic, seed)

        def client() -> None:
            while time.perf_counter() < t_end:
                q, keep = log.take()
                rec = self._serve_one(q, keep)
                with lock:
                    done.append(rec)
                if rec.error is not None:
                    return

        threads = [threading.Thread(target=client, name=f"client-{i}")
                   for i in range(int(self.traffic.get("clients", 1)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(seconds + 2 * RESULT_TIMEOUT_S)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client did not finish its last query")
        return done

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
        self.server = self.static = self.static_fn = None


def open_program(cell, raw: np.ndarray, seed: int, device: str) -> Program:
    """Hand the program the raw draw and set it up: the database
    (``graph_db``: symmetrised, self loops dropped, deduplicated, as the
    program does it), the entry point, and one query of each shape of the
    mix, which builds the kernels and the plan and warms the tables."""
    from repro_torch.core.db import graph_db
    g = cell.config["graph"]
    db = graph_db(raw, name=cell.config.get("relation", "E"),
                  symmetrize=bool(g.get("symmetrize", False)))
    prog = Program(cell, db, device)
    prog.setup(seed)
    return prog
