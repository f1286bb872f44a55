"""The port stands alone: it imports with neither ``jax`` nor the JAX
reference package ``repro`` importable, no file of it names either, and
its entry points run on the card unless the caller asks for the CPU —
without CUDA, the default raises instead of carrying on quietly."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .replace(".__init__", "")
    for p in PKG.rglob("*.py"))


def test_imports_without_jax_and_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert len(MODULES) >= 20
    # the host engines, the FOLD / EMIT chains, the training modules, the
    # block families and the cost tools are among them
    assert {f"repro_torch.core.{m}" for m in (
        "trie", "lftj_ref", "bruteforce", "clftj_ref", "yannakakis",
        "trace")} | {
        "repro_torch.kernels.fold.chain",
        "repro_torch.kernels.emit.chain"} | {f"repro_torch.{m}" for m in (
            "optim.adamw", "train.train_step", "train.loop",
            "checkpoint.ckpt", "runtime.fault", "runtime.elastic",
            "sharding.rules", "launch.train", "models.moe", "models.rglru",
            "models.rwkv6", "configs.whisper_tiny",
            "configs.recurrentgemma_2b", "launch.shapes", "launch.mesh",
            "launch.dryrun", "launch.report", "launch.roofline",
            "launch.costprobe", "launch.hillclimb",
            "launch.dryrun_join")} <= set(MODULES)


IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_no_file_imports_jax_or_reference():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files if IMPORT_RE.search(p.read_text())]
    assert not offenders


def _small_db():
    from repro_torch.core.db import graph_db
    rng = np.random.default_rng(0)
    return graph_db(rng.integers(0, 8, size=(30, 2)))


@pytest.mark.parametrize("entry", ["count", "evaluate"])
def test_entry_points_default_to_cuda(entry):
    from repro_torch.core import engine
    from repro_torch.core.cq import cycle_query
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    db = _small_db()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(engine, entry)(cycle_query(4), db)
    res = getattr(engine, entry)(cycle_query(4), db, capacity=1 << 8,
                                 device="cpu")
    assert res.count > 0 and res.device == "cpu"


def test_stream_entry_point_defaults_to_cuda():
    from repro_torch.core import engine
    from repro_torch.core.cq import cycle_query
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    db = _small_db()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.evaluate_stream(cycle_query(4), db)
    stream = engine.evaluate_stream(cycle_query(4), db, capacity=1 << 8,
                                    device="cpu")
    rows = sum(b.shape[0] for b in stream)
    assert rows == stream.result.count > 0
    assert stream.result.device == "cpu"


def test_engines_default_to_cuda():
    from repro_torch.convert import static_tables_from_reference
    from repro_torch.core.cached_frontier import CachedTrieJoin
    from repro_torch.core.distributed import StaticCLFTJ
    from repro_torch.core.cq import cycle_query
    from repro_torch.core.decompose import choose_plan
    from repro_torch.core.frontier import TrieJoin
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    db = _small_db()
    q = cycle_query(4)
    td, order = choose_plan(q, db.stats())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CachedTrieJoin(q, td, order, db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrieJoin(q, order, db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StaticCLFTJ(q, td, order, db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        static_tables_from_reference({})


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back to its plain version: given tensors that
    do not lie on a CUDA device it raises before building or launching
    anything, and counts no launch."""
    from repro_torch.core.frontier import Frontier
    from repro_torch.kernels.emit import cuda as emit_cuda
    from repro_torch.kernels.expand import cuda as expand_cuda
    from repro_torch.kernels.fold import cuda as fold_cuda
    from repro_torch.kernels.flash_attention import cuda as flash_cuda
    from repro_torch.kernels.leapfrog import cuda as bound_cuda
    C, n, m = 8, 3, 2
    i32 = torch.int32
    F = Frontier(torch.zeros((C, n), dtype=i32),
                 torch.ones(C, dtype=torch.int64),
                 torch.ones(C, dtype=torch.bool), torch.arange(C, dtype=i32),
                 torch.zeros((C, m), dtype=i32),
                 torch.ones((C, m), dtype=i32))
    col = torch.arange(4, dtype=i32)
    slab = torch.zeros((5, 2), dtype=i32)

    def counts():
        return (expand_cuda.launches, fold_cuda.launches,
                fold_cuda.splice_launches, fold_cuda.merged_launches,
                emit_cuda.launches, bound_cuda.launches, flash_cuda.launches)

    before = counts()
    calls = [
        lambda: expand_cuda.expand(F, col, col, [col], d=0, g_ai=0,
                                   other_ais=(1,), n_rows_g=4),
        lambda: fold_cuda.replay(F, F.valid, F.orig, F, d0=1, d1=2),
        lambda: fold_cuda.splice(F, F.valid, F.orig, F.orig, slab, d0=1,
                                 d1=2),
        lambda: fold_cuda.merged(F, F.valid, F.orig, F, F.valid, F.orig,
                                 F.orig, slab, d0=1, d1=2),
        lambda: emit_cuda.pack(F.assign, F.valid),
        lambda: bound_cuda.bound(col, col, col, col, strict=True),
        lambda: flash_cuda.flash_attention(*[torch.zeros(1, 4, 2, 16)] * 3)]
    for call in calls:
        with pytest.raises(ValueError, match="kernel runs on"):
            call()
    assert counts() == before


def test_serve_defaults_to_cuda():
    """The serving layer's entry points run on the card by default, like
    the facade; ``device="cpu"`` runs the plain kernels."""
    from repro_torch.core import engine
    from repro_torch.core.cq import cycle_query
    from repro_torch.serve import JoinServer, PlanCache
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    db = _small_db()
    for make in (lambda: engine.serve(db), lambda: JoinServer(db),
                 lambda: PlanCache(db)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with engine.serve(db, device="cpu") as srv:
        res = srv.count(cycle_query(4))
    assert res.count > 0 and res.device == "cpu"



def test_lm_defaults_to_cuda():
    """The LM model runs on the card by default, like the join's entry
    points: without CUDA, ``Model`` raises (so ``greedy_generate`` has
    nothing to run) unless ``device="cpu"`` is given; then prefill,
    decode and the generated tokens stay on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.train.serve_step import greedy_generate
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    cfg = get_arch("qwen2.5-3b-smoke")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_generate(Model(cfg), {"tokens": np.zeros((1, 4), int)}, 2)
    model = Model(cfg, device="cpu")
    out = greedy_generate(model, {"tokens": np.zeros((1, 4), int)}, 2)
    assert out.shape == (1, 2) and out.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_training_defaults_to_cuda(tmp_path):
    """Training runs on the card by default: without CUDA the launcher
    raises (as ``Model``, which ``make_train_step`` and ``train`` take,
    does) unless ``--device cpu`` is given; then the loop trains on the
    CPU.  A model-parallel mesh needs several processes (``torchrun``):
    alone, ``--model-parallel 2`` raises.""" 
    from repro_torch.launch import train as launch
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    args = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "8", "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(args)
    with pytest.raises(ValueError, match="several processes"):
        launch.main(args + ["--device", "cpu", "--model-parallel", "2"])
    hist = launch.main(args + ["--device", "cpu"])
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))


def test_meshes_default_to_cuda(tmp_path):
    """A mesh is made on the card unless the caller asks for the CPU:
    without CUDA ``make_local_mesh`` (and ``make_production_mesh``)
    raise, naming the way out; ``device_type="cpu"`` makes a CPU mesh
    over the group's ranks (one here)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_local_mesh(1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_production_mesh()
        mesh = make_local_mesh(1, device_type="cpu")
        assert mesh.device_type == "cpu"
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()
