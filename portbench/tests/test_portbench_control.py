"""``correct`` can fail: the control (the reference over the draw as a
bag, portbench/control.py) fails every cell's checks, and a run whose
program is broken underneath comes out not correct, once for each fault
the cells can have, on every cell and on the generator's served entry.
The cells have no exchange between chips (all run on one card), so that
fault has no case here."""
import numpy as np
import pytest

from portbench_cells import CELLS, tiny_cell, tiny_served
from harness import runner

import control  # portbench/control.py


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    for seed in (1, 2, 2 ** 31 + 9):
        chk = control.control_checks(cell, seed, 6)
        assert not runner.passed(chk), chk
        assert chk["wrong_answers"]["value"] > 0


def _half_frontier(orig):
    """The initial chunk with the top guard atom's window cut to the first
    half of its runs: half of the work left out."""
    def initial_frontier(self):
        F0 = orig(self)
        g_ai, g_lvl = self.at_depth[0][self.guard[0]]
        rs = self.levels[g_ai][g_lvl].runstarts_np
        half = len(rs) // 2
        F0.hi[0, g_ai] = int(rs[half]) if half < len(rs) else \
            self.sizes[g_ai]
        return F0
    return initial_frontier


def _break(monkeypatch, fault):
    from repro_torch.core import cached_frontier, distributed, frontier
    CTJ = cached_frontier.CachedTrieJoin
    count, stream = CTJ.count, CTJ.evaluate_stream
    count_fn = distributed.StaticCLFTJ.count_fn

    def static(transform):
        def make(self):
            fn = count_fn(self)
            return lambda F0: transform(*fn(F0))
        monkeypatch.setattr(distributed.StaticCLFTJ, "count_fn", make)

    if fault == "answer_altered":
        monkeypatch.setattr(CTJ, "count", lambda self: count(self) + 1)

        def altered(self):
            for i, b in enumerate(stream(self)):
                if i == 0 and len(b):
                    b = b.copy()
                    b[0, 0] += 1
                yield b
        monkeypatch.setattr(CTJ, "evaluate_stream", altered)
        static(lambda total, ov: (total + 1, ov))
    elif fault == "half_left_out":
        monkeypatch.setattr(frontier.TrieJoin, "initial_frontier",
                            _half_frontier(frontier.TrieJoin.initial_frontier))
        monkeypatch.setattr(CTJ, "count", lambda self: 2 * count(self))
        monkeypatch.setattr(CTJ, "evaluate_stream", lambda self: (
            b for i, b in enumerate(stream(self)) if i % 2 == 0))
        static(lambda total, ov: (2 * total, ov))
    elif fault == "raises":
        def boom(*args, **kwargs):
            raise RuntimeError("planted fault")
        monkeypatch.setattr(CTJ, "count", boom)
        monkeypatch.setattr(CTJ, "evaluate_stream", boom)
        monkeypatch.setattr(distributed.StaticCLFTJ, "count_fn",
                            lambda self: boom)
    elif fault == "state_unchanged":
        monkeypatch.setattr(CTJ, "count", lambda self: 0)
        monkeypatch.setattr(CTJ, "evaluate_stream",
                            lambda self: (b for b in ()))
        static(lambda total, ov: (total * 0, ov))


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out",
                                   "state_unchanged", "raises"])
@pytest.mark.parametrize("name", CELLS + ("served",))
def test_a_broken_program_is_not_correct(monkeypatch, name, fault):
    cell = tiny_served() if name == "served" else tiny_cell(name)
    _break(monkeypatch, fault)
    line = runner.run(cell, 77, 0.3, False, device="cpu")
    assert line["correct"] is False, line["checks"]
    if fault == "raises":
        assert line["checks"]["failed_queries"]["value"] >= 1


def test_the_checks_pass_a_sound_answer_and_fail_one_row():
    cell = tiny_served()
    from harness import graphs
    from harness.drivers import Record
    from harness.queries import query_log
    from harness.reference import Reference
    g = cell.config["graph"]
    raw = graphs.draw(g, 3)
    nv = graphs.vertices(g)
    ref = Reference(raw, nv, True)
    specs = {f"{q['shape']}{q['size']}": q for q in cell.traffic["queries"]}
    recs = []
    for q in query_log(cell.traffic, 3, 8):
        rows = ref.rows(specs[q.shape])
        recs.append(Record(query=q, t_submit=0, n=len(rows), order=q.names,
                           rows=rows[np.random.default_rng(0).permutation(
                               len(rows))]))
    assert runner.passed(runner.checks(cell, ref, recs, recs))
    recs[-1].rows = recs[-1].rows.copy()
    recs[-1].rows[0, 1] = (recs[-1].rows[0, 1] + 1) % nv
    chk = runner.checks(cell, ref, recs, recs)
    assert chk["wrong_row_sets"]["value"] == 1
    assert not runner.passed(chk)
