"""Tiny copies of the benchmark's cells for the CPU tests: the cell's own
traffic mix and engine knobs over a small draw."""
import copy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import json  # noqa: E402

from harness import spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in BENCH["workloads"])
# a served mix of the generator's other entry (no cell runs one yet):
# two clients streaming 3-cycles and 4-cycles, rows kept for a share
SERVED = {"entry": "server", "mode": "stream", "clients": 2, "block": 3,
          "zipf_s": 1.0, "row_sample": 0.5,
          "queries": [{"shape": "cycle", "size": 3},
                      {"shape": "cycle", "size": 4}]}


def tiny(cell, scale: int = 6, edgefactor: int = 4):
    """``cell`` over a Kronecker draw of ``2**scale`` vertices, with chunks
    and tables small enough that morsels split and tables evict."""
    cell = copy.deepcopy(cell)
    cell.config["graph"].update(scale=scale, edgefactor=edgefactor)
    eng = cell.config["engine"]
    eng["frontier_capacity"] = 1 << 9
    eng["cache_slots"] = 1 << 6
    if "static" in cell.config:
        cell.config["static"]["frontier_capacity"] = 1 << 17
    return cell


def tiny_cell(name: str):
    """The benchmark's cell ``name``, made tiny."""
    return tiny(spec.load_cell(name))


def tiny_served(mode: str = "stream"):
    """The first cell's deployment under :data:`SERVED` in ``mode``, made
    tiny, with the end-to-end metrics of the first cell."""
    cell = spec.load_cell(CELLS[0])
    cell.traffic = dict(SERVED, mode=mode,
                        row_sample=SERVED["row_sample"] if mode == "stream"
                        else 0.0)
    cell.name = f"{cell.config['name']}.served-{mode}"
    cell.per_layer = []
    return tiny(cell)
