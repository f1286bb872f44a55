"""Nothing under portbench/ imports JAX, the JAX package or the reference
benchmarks; top-level names are compared whole, so ``repro_torch`` is
not ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench_cells import tiny_cell  # noqa: F401  (puts harness on the path)
from harness import runner, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.HERE.rglob("*.py"))
    assert len(files) > 20
    for p in files:
        bad = _top_level_imports(p) & FORBIDDEN
        assert not bad, f"{p.relative_to(spec.ROOT)} imports {bad}"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in runner.forbidden_modules()


def test_a_run_without_the_program_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, a run
    exits with another code than 0 and prints no result line."""
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "graph500.static-cycle4-count", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
