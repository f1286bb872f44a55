#!/usr/bin/env python3
"""Time the flash-attention, EXPAND, FOLD (replay-only and merged), EMIT,
bounded-search and tier-2 kernels of two checkouts in turns on one NVIDIA
GPU.

    python3 scripts/kernel_ab.py OTHER_TREE

OTHER_TREE is another checkout of this repository, for example the
parent commit unpacked with ``git archive`` into a git-ignored directory
(``build/parent``).  The script starts one process a measurement, in the
order other, this, this, other; each imports ``repro_torch`` from its own
tree (building that tree's kernels into the tree's ``build/``) and times,
on seeded inputs drawn by this tree's ``chip_smoke.py`` (the same in
every process):

* flash attention at qwen2.5-3b's prefill shape (B = 4, T = S = 2048,
  H = 16, Hkv = 2, Dh = 128, causal, bf16), phase 14's case;
* EXPAND, FOLD replay-only, FOLD merged (payload blocks of up to 16 rows:
  more rows than the chunk holds) and EMIT, each on
  ``chip_smoke.kernel_inputs``: at C = 2^16 on the 4-cycle's plan of the
  wiki-Vote-scale graph, and at C = 2^25 (the static pass's capacity) on
  its plan of the ca-GrQc-scale graph, phase 3's inputs at that size;
* the chain EXPAND with the leapfrog search (``expand_kernel="chain",
  impl="leapfrog"``), one call of the step ``registry.expand_fn`` builds,
  as the engine makes it, on a seeded chunk of C = 2^16 rows
  (``chip_smoke.expand_inputs``) of the 4-cycle's plan of the
  wiki-Vote-scale graph; its busy time also split out for the bounded
  search's own kernels (``ctj::bound*``); and ``ctj_bound`` alone on
  phase 3's 2^16 queries (``chip_smoke.bound_inputs``);
* the tier-2 insert and probe (``core/cache.py::_insert`` and ``_probe``,
  the op chains before the kernels of ``csrc/tier2.cu``) at the static
  cell's shapes (:data:`TIER2`), on seeded keys: medians of 7 calls.

Each time is the median of 25 calls by CUDA events, and the device busy
time a call by torch.profiler, as ``chip_smoke.py`` takes them.  It
prints one JSON line a process, the card's name and power limit, and
last one JSON line with each tree's two readings.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 900
# the tier-2 ops at the static cell's shapes (graph500.static-cycle4-count):
# C = 2^26 rows, a 4-cycle pass's 1,410,739 representatives offered for
# insert and 6,236,814 valid rows probed, each a prefix, fresh 2^19 x 8
# setassoc tables
TIER2 = {"C": 1 << 26, "sets": 1 << 19, "ways": 8, "reps": 1_410_739,
         "probed": 6_236_814}


def measure(tree: Path, label: str) -> dict:
    """One process's readings, with ``repro_torch`` imported from
    ``tree`` (``chip_smoke.py``'s helpers then run on that package)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    import repro_torch
    if tree not in Path(repro_torch.__file__).resolve().parents:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, "
                           f"not {tree}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.db import graph_db
    from repro_torch.data.graphs import zipf_graph
    from repro_torch.kernels import cudalib, registry
    from repro_torch.kernels.emit import cuda as emit_cuda
    from repro_torch.kernels.expand import cuda as expand_cuda
    from repro_torch.kernels.flash_attention import cuda as flash_cuda
    from repro_torch.kernels.fold import cuda as fold_cuda
    from repro_torch.kernels.leapfrog import cuda as bound_cuda

    dev = torch.device("cuda")
    cudalib.load()
    out = {"tree": label, "path": str(tree)}

    case = cs.FLASH_CASES[7]
    b, t, s, h, hkv, dh, causal, window, q_offset = case
    rng = np.random.default_rng(list(case[:6]) + [q_offset])
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dev, torch.bfloat16) for shape in
               ((b, t, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))

    def flash():
        flash_cuda.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)

    out["flash_ms"] = cs.time_ms(flash)
    out["flash_busy_ms"] = cs.busy(flash)["busy_ms"]
    del q, k, v

    db = graph_db(zipf_graph(cs.WIKI["nv"], cs.WIKI["ne"], cs.ZIPF_A,
                             seed=cs.SEED))

    def call(name, inputs):
        if name == "expand":
            F, g_col, g_rs, others, kw = inputs
            return lambda: expand_cuda.expand(F, g_col, g_rs, others, **kw)
        if name == "fold_replay":
            P, active, ror, E, d0, d1 = inputs
            return lambda: fold_cuda.replay(P, active, ror, E, d0=d0, d1=d1)
        if name == "fold_merged":
            args, d0, d1 = inputs
            return lambda: fold_cuda.merged(*args, d0=d0, d1=d1)
        assign, valid = inputs
        return lambda: emit_cuda.pack(assign, valid)

    for graph, cap, size in ((db, cs.C, "2^16"),
                             (cs.grqc_db(), cs.C_STATIC, "2^25")):
        eng, _ = cs.cycle_engine(graph, dev)
        for name in cs.STATIC_SCALE:
            inputs = cs.kernel_inputs(name, eng, dev, cap)
            fn = call(name, inputs)
            out[f"{name}_{size}_ms"] = cs.time_ms(fn)
            out[f"{name}_{size}_busy_ms"] = cs.busy(fn)["busy_ms"]
            del inputs, fn
            torch.cuda.empty_cache()

    eng, _ = cs.cycle_engine(db, dev)
    d = cs.expand_depth(eng)
    F = cs.expand_inputs(eng, d, np.random.default_rng([cs.SEED, cs.C, d]),
                         dev)[0]
    args = eng.expand_kernel_args(d)
    step = registry.expand_fn(
        registry.ExpandSpec(capacity=cs.C, n_vars=eng.n, n_atoms=eng.m,
                            n_others=len(args["other_ais"])),
        path="chain", impl="leapfrog", **args)
    out["chain_expand_2^16_ms"] = cs.time_ms(lambda: step(F))
    ops = cs.busy_ops(lambda: step(F))
    out["chain_expand_2^16_busy_ms"] = sum(ops.values())
    out["chain_expand_2^16_bound_busy_ms"] = sum(
        t for k, t in ops.items() if "ctj::bound" in k)
    out["chain_expand_2^16_busy_by_op"] = {k.split("(")[0][:60]: t
                                           for k, t in ops.items()}
    col, v, lo, hi = cs.bound_inputs(eng, np.random.default_rng(cs.SEED),
                                     dev)

    def bound():
        bound_cuda.bound(col, v, lo, hi, strict=True)

    out["bound_2^16_ms"] = cs.time_ms(bound)
    out["bound_2^16_busy_ms"] = cs.busy(bound)["busy_ms"]
    del col, v, lo, hi, F, eng
    torch.cuda.empty_cache()

    from repro_torch.core import cache
    C, S, W = TIER2["C"], TIER2["sets"], TIER2["ways"]
    rng = np.random.default_rng(cs.SEED)
    keys = torch.from_numpy(rng.integers(0, 1 << 40, C)).to(dev)
    vals = torch.from_numpy(rng.integers(1, 1 << 10, C)).to(dev)
    rows = torch.arange(C, device=dev)
    table = tuple(torch.zeros((S, W), dtype=dt, device=dev) for dt in (
        torch.int64, torch.int64, torch.bool, torch.int32, torch.int64))
    reps, probed = rows < TIER2["reps"], rows < TIER2["probed"]
    for name, fn in (
            ("insert", lambda: cache._insert(*table, keys, vals, vals, reps,
                                             2, policy="setassoc", rounds=W)),
            ("probe", lambda: cache._probe(*table[:4], keys, probed, 1))):
        out[f"tier2_{name}_2^26_ms"] = cs.time_ms(fn, reps=7)
        out[f"tier2_{name}_2^26_busy_ms"] = cs.busy(fn, reps=7)["busy_ms"]
    return out


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    runs = []
    for tree, label in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                        (other, "other")):
        r = subprocess.run([sys.executable, __file__, "--measure", str(tree),
                            label], capture_output=True, text=True,
                           timeout=TIMEOUT_S)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    keys = [k for k in runs[0] if k.endswith("_ms")]
    print(json.dumps({label: {k: [r[k] for r in runs if r["tree"] == label]
                              for k in keys}
                      for label in ("other", "this")}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(Path(sys.argv[2]).resolve(), sys.argv[3])))
        sys.exit(0)
    sys.exit(main())
