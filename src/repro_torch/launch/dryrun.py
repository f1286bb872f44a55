"""Multi-pod dry-run: every (arch × shape × mesh) cell on a fake process
group, nothing allocated: each rank's memory and roofline terms.

The counterpart of the reference's ``repro/launch/dryrun.py``.  The
reference lowers each cell's step ahead of time on 256 or 512 forced
host devices; here one process joins PyTorch's fake process group of 256
or 512 ranks (``torch.testing._internal.distributed.fake_pg``: its
collectives return at once), builds the production mesh on it, places
the cell's arguments as DTensors with meta-device shards (shapes and
dtypes, no storage) and runs the cell's train step, prefill or decode
step once on them.  A record holds, for one rank of the mesh:

* ``memory.argument_bytes``: the exact bytes of that rank's local shards
  of every argument (train state or serving params, caches, and the
  batch, ``batch_bytes`` of them): what the CUDA caching allocator counts
  as requested for them on a card (``requested_bytes`` of
  ``torch.cuda.memory_stats()``; ``memory_allocated()`` counts its
  blocks, rounded up);
* ``memory.peak_bytes``: the peak of its live (meta) bytes while the step
  runs, arguments included (``torch.distributed._tools.mem_tracker``),
  and ``temp_bytes = peak_bytes - argument_bytes``, with attention
  modelled by the flash kernel's allocations (:class:`KernelAllocations`);
* ``trace_s``: the seconds the memory run took on the host;
* ``roofline`` (``launch/roofline.py``'s terms on the H100) and
  ``probe_points``: the two-point cost probe's per-rank FLOPs, bytes and
  collective bytes (``launch/costprobe.py``), unless ``--no-probe`` (the
  memory record alone, as the reference's ``--no-probe`` keeps its raw
  analysis); ``probe_s``, its seconds.

A cell whose step fails records ``status: "error"`` and the message, as
the reference's ``main`` does; ``long_500k`` on a full-attention arch is
``skipped`` (``shapes.cell_supported``).  Results append incrementally
to a JSON file (``launch/report.py`` renders it).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import ARCHS, get_arch
from ..kernels.flash_attention import ops as fa_ops
from ..models import Model
from ..models.specs import TensorSpec
from ..sharding import rules as shr
from ..train.train_step import (TrainConfig, init_train_state,
                                make_train_step, place_parameters,
                                state_shardings)
from .mesh import make_production_mesh
from .shapes import SHAPES, ShapeCase, batch_specs, cell_supported

FSDP_MODES = ("zero3", "zero3_outdim", "zero1", "tp")


# ---------------------------------------------------------------------------
# Shardings of the abstract inputs
# ---------------------------------------------------------------------------

def param_shardings(model: Model, mesh, rules=None) -> Dict:
    return shr.tree_shardings(mesh, model.logical_axes(),
                              model.param_shapes(), rules)


def train_shardings(model: Model, mesh, fsdp: str = "zero3") -> Dict:
    """The train state's shardings under an ``fsdp`` mode: ``"zero3"``
    (parameters and moments under FSDP_RULES), ``"zero3_outdim"``
    (MOE_FSDP_OUTDIM), ``"zero1"`` (parameters by the default rules,
    moments under FSDP_RULES) or ``"tp"`` (the default rules)."""
    if fsdp == "zero3":
        return state_shardings(model, mesh, shr.FSDP_RULES)
    if fsdp == "zero3_outdim":
        return state_shardings(model, mesh, shr.MOE_FSDP_OUTDIM)
    if fsdp == "zero1":
        return state_shardings(model, mesh, None, opt_rules=shr.FSDP_RULES)
    if fsdp == "tp":
        return state_shardings(model, mesh)
    raise ValueError(f"fsdp {fsdp!r}: one of {FSDP_MODES}")


def serve_rules(model: Model, mesh):
    """TP serving; weight-gathered (ZeRO-inference) only when bf16 weights
    exceed 12 GiB a rank under pure TP (e.g. qwen3-235b)."""
    tp = shr.mesh_shape(mesh).get("model", 1)
    if model.param_count() * 2 / tp > 12 * 2 ** 30:
        return shr.FSDP_RULES
    return None


_CACHE_LOGICAL = {
    # leaf name -> logical axes, rightmost dims (leading dims -> None).
    # Dense caches shard their depth (kv_seq) over 'model': every
    # assigned arch has kv_heads <= 8, which never divides a 16-way axis.
    "k": ("batch", "kv_seq", None, None),
    "v": ("batch", "kv_seq", None, None),
    "xk": ("batch", "kv_seq", None, None),
    "xv": ("batch", "kv_seq", None, None),
    "kpos": (None,),
    "h": ("batch", "rnn"),
    "conv": ("batch", None, "rnn"),
    "s": ("batch", "heads", None, None),
    "shift_t": ("batch", None),
    "shift_c": ("batch", None),
}


def cache_shardings(cache_struct, mesh):
    """A sharding for every cache leaf (one dict a layer): the batch split
    when the data (and pod) axes divide it, the logical axes of
    ``_CACHE_LOGICAL`` otherwise."""
    def leaf(name, s: TensorSpec):
        logical = _CACHE_LOGICAL[name]
        full = (None,) * (len(s.shape) - len(logical)) + logical
        spec = []
        for dim, lg in zip(s.shape, full):
            if lg == "batch":
                b = shr.batch_sharding(mesh, dim)
                spec.append(b[0] if b else None)
            elif lg is None:
                spec.append(None)
            else:
                spec.append(shr.partition_spec((lg,), (dim,), mesh)[0])
        return shr.NamedSharding(mesh, tuple(spec))
    return [{name: leaf(name, s) for name, s in layer.items()}
            for layer in cache_struct]


def _placed(spec: TensorSpec, sharding) -> torch.Tensor:
    """A DTensor of ``spec`` on the meta device placed by ``sharding`` (a
    plain meta tensor when None: one process's)."""
    t = torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    return t if sharding is None else shr.place(t, sharding)


def batch_arguments(cfg, case: ShapeCase, mesh) -> Dict:
    return {k: _placed(s, None if mesh is None else
                       shr.batch_named_sharding(mesh, s.shape))
            for k, s in batch_specs(cfg, case).items()}


def local_bytes(t) -> int:
    """The bytes of this rank's shard of ``t``."""
    local = t.to_local() if hasattr(t, "device_mesh") else t
    return local.numel() * local.element_size()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

class KernelAllocations(torch.autograd.Function):
    """The flash kernel's allocations, shape for shape, on meta tensors:
    forward allocates the output (the kernel's only allocation) and
    keeps q, k and v; backward allocates their gradients.  Nothing is
    computed (meta tensors hold no values).  The plain path's blocked
    recompute in backward (``cuda.FlashAttention``) adds block
    temporaries of B·H·512·1024 fp32 scores a step on the card, which
    this does not model.  ``count(q, k, masks, backward)``, when given,
    is told of each call (the cost probe adds its FLOPs)."""

    @staticmethod
    def forward(ctx, q, k, v, masks, count):
        ctx.save_for_backward(q, k, v)
        ctx.masks, ctx.count = masks, count
        if count is not None:
            count(q, k, masks)
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        if ctx.count is not None:
            ctx.count(q, k, ctx.masks, backward=True)
        return tuple(torch.empty_like(x) for x in (q, k, v)) + (None, None)


@contextlib.contextmanager
def attention_as_kernel(count=None):
    """Inside, attention on local (meta) tensors is
    :class:`KernelAllocations` (told of each call through ``count``):
    the card's kernel, where the meta tensors would otherwise run the
    plain path block by block (tens of thousands of ops a layer at 32k
    tokens)."""
    real = fa_ops.flash_attention

    def on_card(q, k, v, **kw):
        if hasattr(q, "device_mesh"):
            return real(q, k, v, **kw)
        return KernelAllocations.apply(q, k, v, kw, count)
    fa_ops.flash_attention = on_card
    try:
        yield
    finally:
        fa_ops.flash_attention = real


def place_cell(cfg, case: ShapeCase, mesh, microbatches: int = 4,
               grad_dtype: str = "float32", fsdp: str = "zero3",
               srules=None):
    """The cell's arguments placed on ``mesh`` (a ``DeviceMesh``, a fake
    group's in the dry-run) as meta-device DTensors, nothing allocated:
    (state leaves, batch, run), ``run()`` taking the cell's step once.
    ``fsdp`` picks the train state's shardings (:func:`train_shardings`);
    serving cells place bf16 parameters by ``srules`` (the default rules
    when None) and, for decode, the caches by :func:`cache_shardings`.
    With ``mesh=None`` the arguments are one process's meta tensors."""
    model = Model(cfg, device="meta")
    batch = batch_arguments(cfg, case, mesh)
    if case.kind == "train":
        mb = microbatches if case.batch % microbatches == 0 else 1
        state = init_train_state(model) if mesh is None else \
            init_train_state(model, mesh, train_shardings(model, mesh, fsdp))
        step = make_train_step(model, TrainConfig(
            microbatches=mb, grad_dtype=grad_dtype), mesh)
        return list(_leaves(state)), batch, lambda: step(state, batch)
    if mesh is None:
        params = dict(model.to(torch.bfloat16).named_parameters())
    else:
        params = place_parameters(model, param_shardings(model, mesh,
                                                         srules),
                                  dtype=torch.bfloat16)
    if case.kind == "prefill":
        def run():
            with model.spmd():
                return model.prefill(batch)
        return list(params.values()), batch, run
    cstruct = model.cache_shapes(case.batch, case.seq)
    shardings = [dict.fromkeys(layer) for layer in cstruct] if mesh is None \
        else cache_shardings(cstruct, mesh)
    caches = [{n: _placed(s, sh[n]) for n, s in layer.items()}
              for layer, sh in zip(cstruct, shardings)]

    def run():
        with model.spmd():
            return model.decode(caches, batch["tokens"], case.seq - 1)
    return list(params.values()) + list(_leaves(caches)), batch, run


def run_cell(cfg, case: ShapeCase, mesh, microbatches: int = 4,
             grad_dtype: str = "float32", fsdp: str = "zero3",
             srules=None) -> Dict:
    """:func:`place_cell`, then its step once under the memory tracker:
    the memory record of one rank."""
    from torch.distributed._tools.mem_tracker import MemTracker
    state, batch, run = place_cell(cfg, case, mesh, microbatches,
                                   grad_dtype, fsdp, srules)
    args = state + list(batch.values())
    tracker = MemTracker()
    tracker.track_external(*args)
    with tracker, attention_as_kernel():
        run()
    peak = max(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    argument = sum(local_bytes(t) for t in args)
    return {"argument_bytes": argument,
            "batch_bytes": sum(local_bytes(t) for t in batch.values()),
            "peak_bytes": int(peak), "temp_bytes": int(peak) - argument}


def fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks (this process is rank
    0); its collectives move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def lower_cell(arch: str, shape: str, multi_pod: bool,
               remat: Optional[str] = None, microbatches: int = 4,
               fsdp: str = "zero3", probe: bool = True) -> Dict:
    """The record of one cell on the production mesh (256 or 512 fake
    ranks): ``skipped`` as ``cell_supported`` says, else ``ok`` with its
    memory and, with ``probe``, its roofline.  Serving cells decide
    their rules on the full config (:func:`serve_rules`), so the
    reduced-depth probes place as the cell does."""
    import torch.distributed as dist
    cfg = get_arch(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    case = SHAPES[shape]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        srules = serve_rules(Model(cfg, device="meta"), mesh)
        t0 = time.perf_counter()
        mem = run_cell(cfg, case, mesh, microbatches=microbatches,
                       fsdp=fsdp, srules=srules)
        trace_s = time.perf_counter() - t0
        n_dev = mesh.size()
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "n_devices": n_dev, "status": "ok",
               "fsdp": fsdp if case.kind == "train" else
               ("zero3-inference" if srules else "tp"),
               "trace_s": round(trace_s, 3), "memory": mem}
        if probe:
            from . import costprobe
            from . import roofline as rl
            t0 = time.perf_counter()
            pc = costprobe.probe_costs(
                cfg, case, mesh, lambda c, cs, m: costprobe.cell_costs(
                    c, cs, m, microbatches=1, fsdp=fsdp, srules=srules))
            rec["probe_s"] = round(time.perf_counter() - t0, 3)
            rec["roofline"] = rl.from_costs(pc, cfg, case, n_dev).as_dict()
            rec["probe_points"] = pc["probe_points"]
    finally:
        dist.destroy_process_group()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--remat", default=None)
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-probe", action="store_true")
    args = ap.parse_args()

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "multi" if mp else "single")
                if args.skip_done and key in done:
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape, mp, remat=args.remat,
                                     microbatches=args.microbatches,
                                     probe=not args.no_probe)
                except Exception as e:   # a failure here is a bug: record it
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "trace": traceback.format_exc()[-2000:]}
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                if rec["status"] == "ok":
                    m = rec["memory"]
                    roof = ""
                    if "roofline" in rec:
                        r = rec["roofline"]
                        roof = (f"  dominant={r['dominant']}  roofline_frac="
                                f"{r['roofline_fraction']:.3f}")
                    print(f"  ok: {rec['trace_s']} s  args "
                          f"{m['argument_bytes'] / 2 ** 30:.2f} GiB/dev  "
                          f"peak {m['peak_bytes'] / 2 ** 30:.2f} GiB/dev  "
                          f"temp {m['temp_bytes'] / 2 ** 30:.2f} GiB/dev"
                          + roof, flush=True)
                else:
                    print(f"  {rec['status']}: "
                          f"{rec.get('reason', rec.get('error', ''))[:200]}",
                          flush=True)


if __name__ == "__main__":
    main()
