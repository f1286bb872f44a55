"""The memory dry-run's grid, shapes and placements against the JAX
reference's, and one cell on a fake process group of 256 ranks.

The reference's ``partition_spec`` reads only a mesh's ``axis_names`` and
``shape``; it is given a stand-in with those two (``_FakeMesh``).  The
reference stacks the layers of a pattern group under a leading
``"layers"`` axis, which maps to no mesh axis: a port layer's spec is the
stacked leaf's without its first entry."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_arch as ref_get_arch
from repro.launch import shapes as ref_shapes
from repro.models import Model as RefModel
from repro.sharding import rules as ref_rules
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import dryrun, shapes
from repro_torch.models import Model
from repro_torch.sharding import rules

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
# the reference's four rule sets of the dry-run's fsdp modes: (params,
# moments); None is DEFAULT_RULES
MODES = {"tp": (None, None), "zero3": (ref_rules.FSDP_RULES,) * 2,
         "zero3_outdim": (ref_rules.MOE_FSDP_OUTDIM,) * 2,
         "zero1": (None, ref_rules.FSDP_RULES)}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _ref_leaves(cfg):
    """{port state-dict name: (logical axes, shape, stacked)} of the
    reference's parameter tree (the names ``convert`` gives them)."""
    rmodel = RefModel(ref_get_arch(cfg.name))
    logical, shapes_ = rmodel.logical_axes(), rmodel.param_shapes()
    out = {}

    def flat(prefix, lg, sh, stacked, index=None):
        for name, sub in lg.items():
            if isinstance(sub, dict):
                flat(f"{prefix}{name}.", sub, sh[name], stacked, index)
            else:
                out[f"{prefix}{name}"] = (sub, sh[name].shape, stacked)

    for top in ("embed", "final_norm", "unembed", "img_proj"):
        if top in logical:
            flat(f"{top}.", logical[top], shapes_[top], False)
    pat = cfg.pattern
    for g in range(cfg.n_groups):
        for j, kind in enumerate(pat):
            key = f"b{j}_{kind}"
            flat(f"blocks.{g * len(pat) + j}.", logical["groups"][key],
                 shapes_["groups"][key], True)
    for j, kind in enumerate(pat[: cfg.n_rem_layers]):
        key = f"r{j}_{kind}"
        flat(f"blocks.{cfg.n_groups * len(pat) + j}.", logical["rem"][key],
             shapes_["rem"][key], False)
    if "encoder" in logical:
        enc, enc_sh = logical["encoder"], shapes_["encoder"]
        for i in range(cfg.n_encoder_layers):
            flat(f"encoder.blocks.{i}.", enc["groups"]["b0_enc"],
                 enc_sh["groups"]["b0_enc"], True)
        for top in ("final_norm", "in_proj"):
            flat(f"encoder.{top}.", enc[top], enc_sh[top], False)
    return out


def _ref_spec(leaf, mesh, rules_):
    logical, shape, stacked = leaf
    spec = tuple(ref_rules.partition_spec(logical, shape,
                                          _FakeMesh(mesh), rules_))
    if stacked:
        assert spec[0] is None        # "layers" maps to no mesh axis
        return spec[1:]
    return spec


def test_grid_and_skips_equal_the_references():
    assert list(ARCHS) == list(REF_ARCHS) and len(ARCHS) == 10
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    assert len(shapes.SHAPES) == 4
    assert shapes.SUBQUADRATIC == ref_shapes.SUBQUADRATIC
    skipped = 0
    for name in ARCHS:
        for sh in shapes.SHAPES:
            got = shapes.cell_supported(get_arch(name), sh)
            assert got == ref_shapes.cell_supported(ref_get_arch(name), sh)
            skipped += not got[0]
        for sh, case in shapes.SHAPES.items():
            ref = ref_shapes.SHAPES[sh]
            assert (case.name, case.kind, case.seq, case.batch) == (
                ref.name, ref.kind, ref.seq, ref.batch)
    assert skipped == 8


@pytest.mark.parametrize("name", list(ARCHS))
def test_batch_specs_equal_the_references(name):
    dt = {"int32": torch.int32, "bfloat16": torch.bfloat16}
    for sh, case in shapes.SHAPES.items():
        got = shapes.batch_specs(get_arch(name), case)
        want = ref_shapes.batch_specs(ref_get_arch(name),
                                      ref_shapes.SHAPES[sh])
        assert list(got) == list(want)
        for k, s in got.items():
            assert s.shape == want[k].shape
            assert s.dtype == dt[str(want[k].dtype)], (sh, k)


@pytest.mark.parametrize("name", list(ARCHS))
def test_partition_specs_equal_the_references(name):
    """Every parameter (and its moments) of the full-size arch, on both
    production meshes, under the dry-run's four fsdp modes."""
    cfg = get_arch(name)
    model = Model(cfg, device="meta")
    ref = _ref_leaves(cfg)
    assert set(ref) == set(model.logical_axes())
    for name_, p in model.named_parameters():
        assert p.spec.logical == (ref[name_][0][1:] if ref[name_][2]
                                  else ref[name_][0])
        assert tuple(p.shape) == (ref[name_][1][1:] if ref[name_][2]
                                  else ref[name_][1])
    for mesh in MESHES.values():
        for mode, (prules, orules) in MODES.items():
            got = dryrun.train_shardings(model, mesh, mode)
            for name_, leaf in ref.items():
                assert got["params"][name_].spec == _ref_spec(
                    leaf, mesh, prules), (mode, name_)
                assert got["opt"]["m"][name_].spec == _ref_spec(
                    leaf, mesh, orules), (mode, name_)
            assert got["opt"]["step"].spec == ()


def _want_argument_bytes(cfg, case, mesh, srules):
    """The bytes of one rank's shards of a cell's arguments, from the
    reference's specs and shapes."""
    def local(shape, spec, itemsize):
        n = itemsize
        for dim, target in zip(shape, spec + (None,) * len(shape)):
            n *= dim // int(np.prod([mesh[a] for a in
                                     rules.target_axes(target)] or [1]))
        return n

    total = 0
    for k, s in ref_shapes.batch_specs(cfg, case).items():
        spec = tuple(ref_rules.batch_spec(_FakeMesh(mesh)))
        if spec and s.shape[0] % np.prod(
                [mesh[a] for a in rules.target_axes(spec[0])]):
            spec = ()
        total += local(s.shape, spec, s.dtype.itemsize)
    leaves = _ref_leaves(cfg).values()
    if case.kind == "train":
        for leaf in leaves:
            size = local(leaf[1], _ref_spec(leaf, mesh, ref_rules.FSDP_RULES)
                         if not leaf[2] else (None,) + _ref_spec(
                             leaf, mesh, ref_rules.FSDP_RULES), 4)
            total += 3 * (size // (leaf[1][0] if leaf[2] else 1))
        return total + 4                        # the int32 step
    for leaf in leaves:
        spec = _ref_spec(leaf, mesh, srules)
        size = local(leaf[1], (None,) + spec if leaf[2] else spec, 2)
        total += size // (leaf[1][0] if leaf[2] else 1)
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_argument_bytes_equal_the_reference_specs(mesh_name):
    """Each supported cell's arguments, placed on the production mesh of
    a fake group (meta shards): one rank's bytes equal the sum over the
    reference's specs (train: params, m, v in fp32 under FSDP_RULES, the
    step; serving: bf16 params under the serving rules; plus the
    batch).  Decode adds the caches, counted here from their shapes."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    multi = mesh_name == "multi"
    dryrun.fake_group(512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        for name in ARCHS:
            cfg = get_arch(name)
            srules = dryrun.serve_rules(Model(cfg, device="meta"), mesh)
            for sh, case in shapes.SHAPES.items():
                if not shapes.cell_supported(cfg, sh)[0]:
                    continue
                state, batch, _ = dryrun.place_cell(cfg, case, mesh,
                                                    srules=srules)
                got = sum(dryrun.local_bytes(t)
                          for t in state + list(batch.values()))
                want = _want_argument_bytes(
                    ref_get_arch(name), ref_shapes.SHAPES[sh],
                    MESHES[mesh_name], srules)
                if case.kind == "decode":
                    cstruct = Model(cfg, device="meta").cache_shapes(
                        case.batch, case.seq)
                    shards = dryrun.cache_shardings(cstruct, mesh)
                    for layer, sl in zip(cstruct, shards):
                        for k, s in layer.items():
                            n = s.dtype.itemsize
                            for dim, t in zip(s.shape, sl[k].spec):
                                n *= dim // int(np.prod(
                                    [MESHES[mesh_name][a] for a in
                                     rules.target_axes(t)] or [1]))
                            want += n
                assert got == want, (name, sh)
    finally:
        dist.destroy_process_group()


def test_dryrun_cell_production_mesh():
    """The reference's ``test_dryrun_cell_production_mesh`` on the port:
    whisper-tiny ``train_4k`` on the 256-rank production mesh of a fake
    group is ``ok``, with its memory record (``probe=False``: the memory
    record alone, as ``--no-probe``)."""
    rec = dryrun.lower_cell("whisper-tiny", "train_4k", multi_pod=False,
                            probe=False)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > mem["batch_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    skipped = dryrun.lower_cell("whisper-tiny", "long_500k", False)
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == ref_shapes.cell_supported(
        ref_get_arch("whisper-tiny"), "long_500k")[1]


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
def test_moe_cells_on_the_production_mesh(shape):
    """The MoE (qwen3-moe-smoke: 4 experts, top 2) in each of the four
    shapes on the 256-rank production mesh of a fake group: ``ok`` or
    ``skipped`` as ``cell_supported`` says (the experts split over
    ``"model"``, zero3 training, the serving rules), each ``ok`` record
    with its memory, ``trace_s``, the roofline on the H100 and the
    probe's two points."""
    name = "qwen3-moe-235b-a22b-smoke"
    rec = dryrun.lower_cell(name, shape, multi_pod=False, microbatches=1)
    ok, why = shapes.cell_supported(get_arch(name), shape)
    assert rec["status"] == ("ok" if ok else "skipped"), rec.get("error")
    if not ok:
        assert rec["reason"] == why
        return
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > mem["batch_bytes"]
    assert rec["trace_s"] > 0 and rec["probe_s"] > 0
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert set(rec["probe_points"]) == {"one_group", "two_groups"}


def test_moe_serve_rules_cell_on_a_fake_mesh():
    """``run_cell`` of a smoke MoE prefill (qwen3-moe-smoke: 4 experts,
    top 2) under MOE_SERVE_RULES on a fake (2, 2) mesh runs the expert-
    data branch (its token all-to-all on meta tensors): its record
    counts a rank's arguments, whose expert weights (``wg``, ``wi``,
    ``wo``) are a quarter of the whole, split over ``"data"`` by expert
    and over ``"model"`` by FFN width."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.train.train_step import place_parameters
    cfg = get_arch("qwen3-moe-235b-a22b-smoke")
    case = shapes.ShapeCase("p", "prefill", 16, 4)
    dryrun.fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        mem = dryrun.run_cell(cfg, case, mesh, srules=rules.MOE_SERVE_RULES)
        model = Model(cfg, device="meta")
        params = place_parameters(
            model, dryrun.param_shardings(model, mesh, rules.MOE_SERVE_RULES),
            dtype=torch.bfloat16)
    finally:
        dist.destroy_process_group()
    assert mem["peak_bytes"] >= mem["argument_bytes"] > mem["batch_bytes"]
    assert mem["argument_bytes"] == mem["batch_bytes"] + sum(
        dryrun.local_bytes(p) for p in params.values())
    experts = [n for n in params if n.split(".")[-1] in ("wg", "wi", "wo")
               and ".moe." in n]
    assert len(experts) == 3 * cfg.n_layers
    whole = sum(params[n].numel() * 2 for n in experts)
    assert sum(dryrun.local_bytes(params[n]) for n in experts) * 4 == whole
    assert str(params["blocks.0.moe.wi"].placements) == \
        "(Shard(dim=0), Shard(dim=2))"


@pytest.mark.parametrize("kind,steps", [("prefill", 16), ("decode", 20)])
def test_moe_serve_rules_over_pod_and_data_on_a_fake_mesh(kind, steps):
    """The expert-data MoE on a fake (pod 2, data 2, model 2) mesh under
    MOE_SERVE_RULES: the experts split over ``("pod", "data")``, their
    exchange group flattened from those two axes, pod-major (this rank's
    four peers of its ``"model"`` coordinate in the order the experts
    are split), built once a mesh; the cost probe counts a rank's token
    all-to-all as 2 x MoE layers x B_l x E x capacity x D bf16 bytes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import costprobe
    from repro_torch.models import moe
    cfg = get_arch("qwen3-moe-235b-a22b-smoke")
    case = shapes.ShapeCase("p", kind, steps, 8)
    dryrun.fake_group(8)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        group = moe._expert_group(mesh, ("pod", "data"))
        assert moe._expert_group(mesh, ("pod", "data")) is group
        ranks = dist.get_process_group_ranks(group)
        costs = costprobe.cell_costs(cfg, case, mesh,
                                     srules=rules.MOE_SERVE_RULES)
    finally:
        dist.destroy_process_group()
    assert ranks == [0, 2, 4, 6]
    E, K, D = cfg.n_experts, cfg.top_k, cfg.d_model
    cap = K if kind == "decode" else \
        max(1, int(steps * K * cfg.capacity_factor / E))
    b_l = case.batch // 4
    n_moe = cfg.layer_kinds().count("moe")
    assert costs["coll_all-to-all"] == 2 * n_moe * b_l * E * cap * D * 2
