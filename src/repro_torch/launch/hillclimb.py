"""Perf hillclimbing over dry-run cells: run named variants of a cell on
the fake process group and report their roofline terms and memory.

The counterpart of the reference's ``repro/launch/hillclimb.py``, with
its ``VARIANTS`` (train, moe and serve) and its CLI.  ``measure`` is one
rank's memory (``dryrun.run_cell``) beside the two-point probe's
roofline on the H100 (``costprobe.probe_costs``, ``roofline.py``), both
on the production mesh of a fake group; a variant that fails records
``error``, as the reference's does.  ``expert_data`` serves under
MOE_SERVE_RULES (the expert axis over the data axes): its record counts
the token exchange's all-to-all bytes (``models/moe.py``), where
``zero_inference`` counts the weights' all-gathers.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell minitron-8b:train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..configs import get_arch
from ..models import Model
from ..sharding import rules as shr
from . import costprobe
from . import dryrun
from . import roofline as rl
from .mesh import make_production_mesh
from .shapes import SHAPES


def measure(cfg, case, mesh, microbatches=8, grad_dtype="float32",
            fsdp="zero3", srules=None):
    """One rank's memory (GiB) and roofline terms of ``cfg``'s cell on
    ``mesh``: ``srules`` ``"fsdp"``, ``"moe"`` or ``"tp"`` picks the
    serving rules (FSDP_RULES, MOE_SERVE_RULES, DEFAULT_RULES), None
    the dry-run's choice (``dryrun.serve_rules``)."""
    rules = {"fsdp": shr.FSDP_RULES, "moe": shr.MOE_SERVE_RULES,
             "tp": dict(shr.DEFAULT_RULES)}.get(srules)
    if srules is None:
        rules = dryrun.serve_rules(Model(cfg, device="meta"), mesh)
    mem = dryrun.run_cell(cfg, case, mesh, microbatches=microbatches,
                          grad_dtype=grad_dtype, fsdp=fsdp, srules=rules)
    pc = costprobe.probe_costs(
        cfg, case, mesh, lambda c, cs, m: costprobe.cell_costs(
            c, cs, m, microbatches=1, grad_dtype=grad_dtype, fsdp=fsdp,
            srules=rules))
    roof = rl.from_costs(pc, cfg, case, mesh.size())
    return {
        "temp_gib": mem["temp_bytes"] / 2 ** 30,
        "arg_gib": mem["argument_bytes"] / 2 ** 30,
        "peak_gib": mem["peak_bytes"] / 2 ** 30,
        **roof.as_dict(),
    }


VARIANTS = {
    "train": [
        ("baseline(mb8,zero3,remat=full)", {}),
        ("tp_only", {"fsdp": "tp"}),
        ("zero1", {"fsdp": "zero1"}),
        ("zero1+seq_shard", {"fsdp": "zero1",
                             "cfg": {"seq_shard": True}}),
        ("zero1+seq_shard+grad_bf16",
         {"fsdp": "zero1", "cfg": {"seq_shard": True},
          "grad_dtype": "bfloat16"}),
        ("seq_shard(zero3)", {"cfg": {"seq_shard": True}}),
        ("mb16", {"microbatches": 16}),
        ("remat_dots", {"cfg": {"remat_policy": "dots"}}),
    ],
    "moe": [
        ("baseline(mb8,fsdp)", {}),
        ("seq_shard", {"cfg": {"seq_shard": True}}),
        ("mb16", {"microbatches": 16}),
        ("capacity1.0", {"cfg": {"capacity_factor": 1.0}}),
        ("zero3_outdim(mlp over data)", {"fsdp": "zero3_outdim"}),
        ("zero3_outdim+seq_shard", {"fsdp": "zero3_outdim",
                                    "cfg": {"seq_shard": True}}),
        ("seq_shard+cap1.0+bf16",
         {"cfg": {"seq_shard": True, "capacity_factor": 1.0},
          "grad_dtype": "bfloat16"}),
    ],
    "serve": [
        ("baseline(auto rules)", {}),
        ("zero_inference(weight-gather)", {"srules": "fsdp"}),
        ("expert_data(a2a tokens)", {"srules": "moe"}),
        ("tp_only", {"srules": "tp"}),
    ],
}


def run_variants(base_cfg, case, mesh, variants, out=None) -> list:
    """``measure`` of each (name, spec) variant in turn: its record, or
    ``error`` with the message; the list is rewritten to ``out`` after
    each."""
    results = []
    for name, spec in variants:
        cfg = dataclasses.replace(base_cfg, **spec.get("cfg", {}))
        kw = {k: v for k, v in spec.items() if k != "cfg"}
        print(f"[hillclimb] {base_cfg.name}:{case.name} :: {name} ...",
              flush=True)
        try:
            m = measure(cfg, case, mesh, **kw)
        except Exception as e:
            print(f"  error: {e}")
            results.append({"variant": name,
                            "error": f"{type(e).__name__}: {e}"[:500]})
            continue
        results.append({"variant": name, **m})
        print(f"  compute {m['compute_s']:.4f}s  memory {m['memory_s']:.4f}s"
              f"  coll {m['collective_s']:.4f}s  temp {m['temp_gib']:.1f}GiB"
              f"  dom={m['dominant']}  frac={m['roofline_fraction']:.3f}",
              flush=True)
        if out:
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
    return results


def main(argv=None) -> list:
    import torch.distributed as dist
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    help="<arch>:<shape>, e.g. minitron-8b:train_4k")
    ap.add_argument("--set", default="train", choices=list(VARIANTS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    dryrun.fake_group(512 if args.multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        return run_variants(get_arch(arch), SHAPES[shape], mesh,
                            VARIANTS[args.set], args.out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
