"""The plain reference against the port run on the CPU, and its two ways
of answering against each other."""
import numpy as np
import pytest

from portbench_cells import tiny_cell  # noqa: F401  (puts harness on the path)
from harness import graphs, queries
from harness.reference import Reference, row_difference

def _draw(scale, seed, edgefactor=8):
    """A small Kronecker draw over ``2**scale`` vertices."""
    return graphs.kronecker_edges(scale, edgefactor, 0.57, 0.19, 0.19, seed)


SHAPES = [("cycle", 3), ("cycle", 4), ("cycle", 5), ("path", 3),
          ("path", 4), ("clique", 3), ("clique", 4)]


@pytest.mark.parametrize("as_set", [True, False])
@pytest.mark.parametrize("sym", [False, True])
def test_counts_by_matrices_equal_the_rows_of_the_join(sym, as_set):
    for seed in range(3):
        raw = _draw(6, seed, 5)
        ref = Reference(raw, 64, sym, as_set)
        for shape, k in SHAPES:
            want = len(ref._join(queries.atoms(shape, k), k))
            assert ref.count({"shape": shape, "size": k}) == want


def test_the_rows_are_every_match_once():
    raw = _draw(5, 4, 6)
    ref = Reference(raw, 32, False)
    rows = ref.rows({"shape": "cycle", "size": 4})
    e = {tuple(x) for x in graphs.edge_set(raw, False).tolist()}
    brute = [(a, b, c, d) for (a, b) in e for (b2, c) in e if b2 == b
             for (c2, d) in e if c2 == c and (a, d) in e]
    assert row_difference(rows, np.asarray(brute).reshape(-1, 4), 32) == 0
    assert len({tuple(r) for r in rows.tolist()}) == len(rows)


def test_row_difference_counts_the_multiset_difference():
    a = np.array([[1, 2], [3, 4], [3, 4]])
    assert row_difference(a, a[::-1], 10) == 0
    assert row_difference(a, a[:2], 10) == 1
    assert row_difference(a, np.array([[1, 2], [3, 5], [3, 4]]), 10) == 2
    wide = np.array([[1, 2, 3, 4, 5, 6, 7]]) * 1000
    assert row_difference(wide, wide + 1, 1 << 21) == 2


@pytest.mark.parametrize("sym,seed", [(False, 0), (True, 1)])
def test_the_reference_equals_the_port_on_the_cpu(sym, seed):
    from repro_torch.core import engine
    from repro_torch.core.cq import CQ, Atom
    from repro_torch.core.db import graph_db
    raw = _draw(7, seed, 4)
    ref = Reference(raw, 128, sym)
    db = graph_db(raw, symmetrize=sym)
    for shape, k in [("cycle", 3), ("cycle", 4), ("path", 3), ("clique", 4)]:
        q = CQ(tuple(Atom("E", a) for a in queries.atoms(shape, k)))
        sp_ = {"shape": shape, "size": k}
        assert engine.count(q, db, device="cpu",
                            capacity=1 << 8).count == ref.count(sp_)
        res = engine.evaluate(q, db, device="cpu", capacity=1 << 8)
        pos = {v: i for i, v in enumerate(res.order)}
        got = res.tuples[:, [pos[f"x{i + 1}"] for i in range(k)]]
        assert row_difference(got, ref.rows(sp_), 128) == 0
