"""A configuration, a traffic mix or a metric dropped into its folder is
found by its name in BENCHMARK.json, with no edit to the harness."""
import json
import shutil

from portbench_cells import tiny_cell  # noqa: F401  (puts harness on the path)
from harness import spec


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path
    pb = root / spec.HERE.name
    shutil.copytree(spec.HERE / "traffic", pb / "traffic")
    shutil.copytree(spec.HERE / "configs", pb / "configs")
    (pb / "metrics").mkdir()
    cfg = json.loads((spec.HERE / "configs" / "graph500.json").read_text())
    cfg["graph"]["scale"] = 9
    (pb / "configs" / "new-graph.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "new-mix.json").write_text(json.dumps(
        {"entry": "server", "mode": "count", "clients": 2,
         "queries": [{"shape": "path", "size": 4}]}))
    (pb / "metrics" / "new.metric_ms.py").write_text(
        "def read(w):\n    return 2 * w.window_s\n")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-graph", "source": "s",
                             "file": f"{pb.name}/configs/new-graph.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "new-graph.new-mix",
                               "config": "new-graph", "traffic": "new-mix",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new.metric_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "serving", "moves": "queries_per_s",
                               "workloads": ["new-graph.new-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("new-graph.new-mix", root)
    assert cell.config["graph"]["scale"] == 9
    assert cell.traffic["queries"] == [{"shape": "path", "size": 4}]
    assert [m["name"] for m in cell.per_layer] == ["new.metric_ms"]
    assert "queries_per_s" not in [m["name"] for m in cell.end_to_end]
    read = spec.readers(cell.per_layer, pb / "metrics")["new.metric_ms"]

    class W:
        window_s = 1.5
    assert read(W()) == 3.0


def test_every_metric_of_the_benchmark_has_its_reader():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
