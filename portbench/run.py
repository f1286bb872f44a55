"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  ``--workload`` names a cell of
``BENCHMARK.json``; its configuration, traffic mix and metrics are files
under ``portbench/`` found by name (``harness/spec.py``).  The run sets
the program up (counted in ``setup_s``), measures for ``--seconds``,
checks every answer against the plain reference, and prints one JSON
line last: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window.  It exits non-zero, printing no result, without the cards
the cell needs or when the JAX package was loaded.
"""
import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# few host threads, and every build cache inside the checkout
os.environ.setdefault("OMP_NUM_THREADS", "4")
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import runner, spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    bad = runner.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 3
    runner.report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
