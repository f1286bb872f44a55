"""The traffic generators and the graph draw repeat under a seed and
differ across seeds; every seed offers the same work."""
import json

import numpy as np
import pytest

from portbench_cells import SERVED, tiny_cell  # noqa: F401  (harness path)
from harness import graphs, queries, spec
from harness.reference import Reference

MIXES = tuple(sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json")))


def _mix(name):
    return json.loads((spec.HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES + ("served",))
def test_log_repeats_under_a_seed_and_differs_across_seeds(mix):
    t = SERVED if mix == "served" else _mix(mix)
    a = queries.query_log(t, 2 ** 31 + 7, 300)
    assert a == queries.query_log(t, 2 ** 31 + 7, 300)
    assert a != queries.query_log(t, 2 ** 31 + 8, 300)
    assert queries.query_log(t, 2 ** 31 + 7, 120) == a[:120]


def test_every_block_of_a_served_log_holds_the_same_shapes():
    t = dict(SERVED, block=23, zipf_s=1.1)
    assert queries.shape_counts(t["queries"], 23, 1.1) == [16, 7]
    for seed in (0, 5, 2 ** 33 + 1, -4):
        log = queries.query_log(t, seed, 230)
        for b in range(10):
            shapes = [q.shape for q in log[23 * b:23 * (b + 1)]]
            assert [shapes.count(s) for s in ("cycle3", "cycle4")] == [16, 7]


def test_a_renaming_is_the_same_query():
    g = graphs.rng(3, "t")
    spec_ = {"shape": "cycle", "size": 4}
    q = queries.renamed(spec_, g, "a")
    back = {n: f"x{i + 1}" for i, n in enumerate(q.names)}
    assert sorted(tuple(back[v] for v in a) for a in q.atoms) == sorted(
        queries.atoms("cycle", 4))
    assert q != queries.renamed(spec_, g, "a")


GRAPH = dict(generator="kronecker", scale=8, edgefactor=16, A=0.57, B=0.19,
             C=0.19, draw_seed=1, symmetrize=True)


def test_the_draw_repeats_under_a_seed_and_relabels_across_seeds():
    """A seed gives one edge list; another seed the same graph under other
    vertex numbers (an isomorphic copy: the same degrees and the same
    answers), so every seed offers the same work."""
    a = graphs.draw(GRAPH, 2 ** 31 + 7)
    assert a.shape == (16 << 8, 2)
    assert np.array_equal(a, graphs.draw(GRAPH, 2 ** 31 + 7))
    b = graphs.draw(GRAPH, 2 ** 31 + 8)
    assert not np.array_equal(a, b)
    ea, eb = graphs.edge_set(a, True), graphs.edge_set(b, True)
    assert len(ea) == len(eb)
    nv = graphs.vertices(GRAPH)
    deg = [np.sort(np.bincount(e[:, 0], minlength=nv)) for e in (ea, eb)]
    assert np.array_equal(*deg)
    ra, rb = Reference(a, nv, True), Reference(b, nv, True)
    for shape, k in [("cycle", 3), ("cycle", 4), ("path", 3)]:
        s = {"shape": shape, "size": k}
        assert ra.count(s) == rb.count(s) > 0


def test_the_draw_follows_the_initiator():
    """Each bit of an edge's endpoints falls in the initiator's quadrants
    with its probabilities: A top left, B top right, C bottom left."""
    e = graphs.kronecker_edges(12, 16, 0.57, 0.19, 0.19, 5)
    assert e.min() >= 0 and e.max() < 1 << 12
    for bit in (0, 6, 11):
        i, j = (e[:, 0] >> bit) & 1, (e[:, 1] >> bit) & 1
        share = [np.mean((i == r) & (j == c)) for r, c in
                 ((0, 0), (0, 1), (1, 0), (1, 1))]
        assert np.allclose(share, [0.57, 0.19, 0.19, 0.05], atol=0.01)
