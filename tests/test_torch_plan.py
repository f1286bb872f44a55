"""The port's planner (``repro_torch.core.decompose.choose_plan``) picks
the same tree decomposition (bags, parents, child order) and the same
variable order as the JAX reference's, and lowers it to the same op
schedule.  Block order in every later comparison depends on it."""
import numpy as np
import pytest

import importlib

from repro.core.cached_frontier import JaxCachedTrieJoin
from repro.core.db import graph_db as r_graph_db
from repro.core.decompose import choose_plan as r_choose_plan
from repro_torch.core.cached_frontier import CachedTrieJoin
from repro_torch.core.db import graph_db as t_graph_db
from repro_torch.core.decompose import choose_plan as t_choose_plan

QUERIES = [("path-4", "path_query", (4,)), ("path-5", "path_query", (5,)),
           ("cycle-4", "cycle_query", (4,)), ("cycle-5", "cycle_query", (5,)),
           ("bowtie", "bowtie_query", ()),
           ("lollipop-3-2", "lollipop_query", (3, 2)),
           ("star-3", "star_query", (3,)), ("star-4", "star_query", (4,))]
GRAPHS = [(30, 8), (60, 10), (120, 14)]
rcq = importlib.import_module("repro.core.cq")
tcq = importlib.import_module("repro_torch.core.cq")


def _edges(i):
    rng = np.random.default_rng(i)
    ne, nv = GRAPHS[i]
    return rng.integers(0, nv, size=(ne, 2))


@pytest.mark.parametrize("gi", range(len(GRAPHS)))
@pytest.mark.parametrize("name,fn,args", QUERIES, ids=[q[0] for q in QUERIES])
def test_choose_plan_matches_reference(name, fn, args, gi):
    edges = _edges(gi)
    rq, tq = getattr(rcq, fn)(*args), getattr(tcq, fn)(*args)
    rdb, tdb = r_graph_db(edges), t_graph_db(edges)
    rtd, rorder = r_choose_plan(rq, rdb.stats())
    ttd, torder = t_choose_plan(tq, tdb.stats())
    assert torder == rorder
    assert ttd.bags == rtd.bags
    assert ttd.parent == rtd.parent
    assert ttd.children == rtd.children
    assert ttd.root == rtd.root


@pytest.mark.parametrize("name,fn,args", QUERIES, ids=[q[0] for q in QUERIES])
def test_lowered_schedule_matches_reference(name, fn, args):
    edges = _edges(1)
    rq, tq = getattr(rcq, fn)(*args), getattr(tcq, fn)(*args)
    rdb, tdb = r_graph_db(edges), t_graph_db(edges)
    rtd, rorder = r_choose_plan(rq, rdb.stats())
    ttd, torder = t_choose_plan(tq, tdb.stats())
    ref = JaxCachedTrieJoin(rq, rtd, rorder, rdb, capacity=1 << 8)
    port = CachedTrieJoin(tq, ttd, torder, tdb, capacity=1 << 8,
                          device="cpu")
    assert port.schedule.describe() == ref.schedule.describe()
    assert port.guard == ref.guard
    assert port.at_depth == ref.at_depth
