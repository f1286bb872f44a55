"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

* configuration ``<config>``: ``portbench/configs/<config>.json``;
* traffic mix ``<traffic>``: ``portbench/traffic/<traffic>.json``;
* metric ``<name>``: ``portbench/metrics/<name>.py``, a module with a
  function ``read(window) -> float | None``.

A later change adds a deployment, a mix or a metric as new files and new
entries in ``BENCHMARK.json``, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["HERE", "ROOT", "Cell", "load_cell", "reader", "readers"]

HERE = Path(__file__).resolve().parents[1]      # portbench/
ROOT = HERE.parent                              # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]      # the metrics a --trace 0 run reports
    per_layer: List[dict]       # the metrics a --trace 1 run reports


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    and traffic mix read from their files."""
    bench = root / "BENCHMARK.json"
    spec = json.loads(bench.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench.name}: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / HERE.name / "traffic" /
                          f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)])


def reader(name: str, folder: Path = HERE / "metrics"
           ) -> Callable[[object], object]:
    """The ``read`` function of metric ``name``'s file."""
    path = folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if mod_spec is None or mod_spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def readers(metrics: List[dict], folder: Path = HERE / "metrics"
            ) -> Dict[str, Callable[[object], object]]:
    return {m["name"]: reader(m["name"], folder) for m in metrics}
