"""The control of ``correct``: the reference put in the program's place
with one stated guarantee broken, which the comparison has to fail.

The deployments state that a relation is a set: the distinct edges of
the draw.  The control answers every query of a cell's window over the
draw as a bag (its duplicate edges kept), the step that would tempt a
change that skips the program's deduplication to shorten set-up.  It
answers the same queries a run's window and warm-up would (the cell's
log under the seed, ``--queries`` of them) and hands them to the same
checks as the program's; every check is printed with its limit.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \
        [--queries 40]
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import graphs, runner, spec  # noqa: E402
from harness.drivers import Record, QueryLog  # noqa: E402
from harness.queries import warmup_queries  # noqa: E402
from harness.reference import Reference  # noqa: E402


def control_records(cell, seed: int, n: int, ref_bag: Reference) -> list:
    """What the control answers for the warm-up and ``n`` queries of the
    cell's log: the bag's count and, for the queries whose rows a run
    would keep (every warm-up query, the rest as ``drivers.QueryLog`` picks
    them), the bag's rows in the canonical column order."""
    specs = {f"{q['shape']}{int(q['size'])}": q
             for q in cell.traffic["queries"]}
    rows = cell.traffic.get("row_sample", 0) > 0
    qs = [(q, rows) for q in warmup_queries(cell.traffic, seed)]
    if cell.traffic["entry"] == "server":
        log = QueryLog(cell.traffic, seed)
        qs += [log.take() for _ in range(n)]
    else:
        qs = qs * (n + 1)
    out = []
    for q, keep in qs:
        spec_ = specs[q.shape]
        rec = Record(query=q, t_submit=0.0, t_done=0.0,
                     n=ref_bag.count(spec_), order=q.names)
        if keep:
            rec.rows = ref_bag.rows(spec_)
        out.append(rec)
    return out


def control_checks(cell, seed: int, n: int) -> dict:
    g = cell.config["graph"]
    nv = graphs.vertices(g)
    raw = graphs.draw(g, seed)
    sym = bool(g.get("symmetrize", False))
    records = control_records(cell, seed, n, Reference(raw, nv, sym,
                                                       as_set=False))
    n_warm = len(warmup_queries(cell.traffic, seed))
    return runner.checks(cell, Reference(raw, nv, sym), records,
                         records[n_warm:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--queries", type=int, default=40)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    failed_all = True
    for seed in args.seeds:
        chk = control_checks(cell, seed, args.queries)
        ok = runner.passed(chk)
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ok, "checks": chk}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
