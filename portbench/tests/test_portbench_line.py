"""A run's result line: its keys, its metrics and its checks, on the CPU
with the cells' own mixes over small draws; and on the card, one short
run of the command as the driver starts it."""
import json
import subprocess
import sys

import pytest

from portbench_cells import CELLS, tiny_cell, tiny_served
from harness import runner, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_the_line_of_a_cpu_run(name, trace):
    cell = tiny_cell(name)
    line = runner.run(cell, 2 ** 31 + 5, 0.5, trace, device="cpu")
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert json.loads(json.dumps(line)) == line
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    assert set(line["metrics"]) <= set(units)
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
        assert set(line["metrics"]) == set(units)
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) >= {"value", "limit"}


@pytest.mark.parametrize("mode", ["count", "stream"])
def test_the_served_entry_is_correct(mode):
    """The generator's server entry, which no cell runs yet, so that a
    later cell can name it from a traffic file alone."""
    line = runner.run(tiny_served(mode), 11, 0.3, False, device="cpu")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 2
    if mode == "stream":
        assert line["checks"]["row_sets_checked"]["value"] >= 2


@pytest.mark.cuda
def test_a_short_run_of_the_command_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         CELLS[0], "--seed", str(2 ** 31 + 3),
         "--seconds", "2", "--trace", "1"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
