"""The port's roofline, cost probe and hillclimb (``launch/{roofline,
costprobe,hillclimb}.py``) against the JAX reference's and against
full-depth counts.

The reference's ``roofline.py`` and ``costprobe.py`` import no JAX; their
formulas (``model_flops``, ``weighted_collective_bytes``, ``_probe_cfg``)
are compared value for value.  The port's counts come from a cell's
step run once on meta tensors (one process, or one rank of a fake
process group), so they are checked against full-depth runs and the
one-process step, not against XLA's cost analysis."""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as ref_get_arch
from repro.launch import costprobe as ref_costprobe
from repro.launch import roofline as ref_roofline
from repro.launch import shapes as ref_shapes
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.flash_attention import cuda as flash_cuda
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import costprobe, dryrun, hillclimb
from repro_torch.launch import roofline as rl
from repro_torch.launch.shapes import SHAPES, ShapeCase
from torch.utils.flop_counter import FlopCounterMode


def _fake_mesh(shape=(2, 2)):
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.fake_group(int(torch.tensor(shape).prod()))
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("name", list(ARCHS))
def test_formulas_equal_the_references(name):
    """``model_flops`` and ``_probe_cfg`` equal the reference's for every
    shape of the arch, ``weighted_collective_bytes`` weighs alike, and
    the H100's peaks (not the TPU's) set the terms."""
    cfg, rcfg = get_arch(name), ref_get_arch(name)
    for sh, case in SHAPES.items():
        for n_dev in (256, 512):
            assert rl.model_flops(cfg, case, n_dev) == \
                ref_roofline.model_flops(rcfg, ref_shapes.SHAPES[sh], n_dev)
    for groups in (1, 2):
        if cfg.encoder_decoder and cfg.n_encoder_layers != cfg.n_groups:
            continue
        assert dataclasses.asdict(costprobe._probe_cfg(cfg, groups)) == \
            dataclasses.asdict(ref_costprobe._probe_cfg(rcfg, groups))
    per_op = dict(zip(rl.COLLECTIVES, (3, 5, 7, 11, 13)))
    assert rl.weighted_collective_bytes(per_op) == \
        ref_roofline.weighted_collective_bytes(per_op) == 6 + 5 + 7 + 11 + 13
    roof = rl.Roofline(989e12, 3.35e12, 450e9, per_op, 1, 989e12 / 2)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == (1, 1, 1)
    assert roof.roofline_fraction == 0.5
    assert set(roof.as_dict()) == set(ref_roofline.Roofline(
        1, 1, 1, per_op, 1).as_dict())
    assert rl.Roofline(67e12, 0, 0, per_op, 1, dtype="float32").compute_s \
        == 1


# (config, the cell, the probe's sequence for an attention-free arch): a
# smoke dense model four groups deep, an MoE, whisper (the encoder scales
# with the groups) and rwkv6 at a sequence four times the probe's
# (sequence scaling)
PROBE_CASES = {
    "dense": ("qwen2.5-3b-smoke", dict(n_layers=4),
              ShapeCase("t", "train", 32, 2), 4096),
    "moe": ("phi3.5-moe-42b-a6.6b-smoke", dict(n_layers=3),
            ShapeCase("t", "train", 32, 2), 4096),
    "whisper": ("whisper-tiny-smoke", dict(n_layers=3, n_encoder_layers=3),
                ShapeCase("p", "prefill", 32, 2), 4096),
    "rwkv6": ("rwkv6-7b-smoke", dict(n_layers=3),
              ShapeCase("t", "train", 256, 1), 64),
}


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_two_point_probe_equals_full_depth(case, monkeypatch):
    """The two-point extrapolation (and rwkv6's sequence scaling) equals
    one full-depth run's counts exactly: FLOPs, bytes, collectives."""
    name, fields, shape, probe_seq = PROBE_CASES[case]
    monkeypatch.setattr(costprobe, "SSM_PROBE_SEQ", probe_seq)
    cfg = dataclasses.replace(get_arch(name), **fields)

    def count(c, cs, m):
        return costprobe.cell_costs(c, cs, m, microbatches=1)
    got = costprobe.probe_costs(cfg, shape, None, count)
    want = count(dataclasses.replace(cfg, cost_exact=True), shape, None)
    assert got["seq_scale"] == (4.0 if case == "rwkv6" else 1.0)
    assert got["probe_points"]["two_groups"]["flops"] > \
        got["probe_points"]["one_group"]["flops"] > 0
    assert got["flops"] == want["flops"]
    assert got["bytes"] == want["bytes"]
    assert got["collectives"] == {k[len("coll_"):]: v for k, v in
                                  want.items() if k.startswith("coll_")}


def test_counts_see_each_ranks_share():
    """On a (2, 2) fake mesh one linear split over both axes counts a
    quarter of its one-process FLOPs; the dense smoke step's rank-0
    count times 4 equals one process's within 1% (every product of a
    dense model is split four ways: a product left whole on a rank is
    named), and its flash FLOPs are exactly a quarter; the step's
    collectives are counted (the gradient all-reduce at least)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.empty(8, 64, device="meta")
    w = torch.empty(64, 32, device="meta")
    one = costprobe.RankCounts()
    with one:
        x @ w
    cfg = get_arch("qwen2.5-3b-smoke")
    case = ShapeCase("t", "train", 64, 8)
    whole = costprobe.RankCounts()
    _, _, run = dryrun.place_cell(cfg, case, None, microbatches=1)
    with whole, dryrun.attention_as_kernel(whole.attention):
        run()
    mesh = _fake_mesh()
    try:
        xd = distribute_tensor(x, mesh, [Shard(0), Replicate()],
                               src_data_rank=None)
        wd = distribute_tensor(w, mesh, [Replicate(), Shard(1)],
                               src_data_rank=None)
        rank = costprobe.RankCounts()
        with rank:
            xd @ wd
        assert rank.flops * 4 == one.flops == 2 * 8 * 64 * 32
        products = {}

        class Named(costprobe.RankCounts):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(costprobe._is_dtensor(t) for t in types):
                    self.op = (str(func), tuple(
                        (tuple(a.shape), str(getattr(a, "placements", "")))
                        for a in args if isinstance(a, torch.Tensor)))
                    return NotImplemented
                before = self.flops
                out = super().__torch_dispatch__(func, types, args, kwargs)
                if self.flops != before:
                    products[self.op] = products.get(self.op, 0) + \
                        self.flops - before
                return out
        counts = Named()
        counts.op = None
        _, _, run = dryrun.place_cell(cfg, case, mesh, microbatches=1,
                                      fsdp="tp")
        with counts, dryrun.attention_as_kernel(counts.attention):
            run()
    finally:
        dist.destroy_process_group()
    assert counts.kernel_flops * 4 == whole.kernel_flops > 0
    assert abs(counts.flops * 4 / whole.flops - 1) <= 0.01, sorted(
        products.items(), key=lambda kv: -kv[1])[:8]
    assert counts.per_op["all-reduce"] > 0


def test_attention_formulas_equal_the_flop_counters(monkeypatch):
    """The flash kernel's forward formula (4·B·H·Dh an attended pair)
    equals FlopCounterMode's count of the plain path (``impl="chain"``)
    on a non-causal shape, where every pair is attended; the backward
    formula equals FlopCounterMode's count of ``cuda.FlashAttention``'s
    backward (the plain path recomputed and differentiated, as on the
    card; here the launch is the kernel's plain version), on shapes of
    one and of several blocks."""
    from repro_torch.kernels.flash_attention import plain
    monkeypatch.setattr(flash_cuda, "flash_attention",
                        plain.flash_attention)
    gen = torch.Generator().manual_seed(3)
    for b, t, s, h, hkv, dh in ((2, 48, 40, 4, 2, 16),
                                (1, 520, 1030, 1, 1, 4)):
        q = torch.randn(b, t, h, dh, generator=gen)
        k, v = (torch.randn(b, s, hkv, dh, generator=gen) for _ in "kv")
        if t < 512:
            with FlopCounterMode(display=False) as fc:
                ops.flash_attention(q, k, v, causal=False, impl="chain")
            assert fc.get_total_flops() == costprobe.attention_flops(
                q.shape, k.shape, causal=False) == 4 * b * h * dh * t * s
        for causal in (True, False):
            qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
            out = flash_cuda.FlashAttention.apply(qg, kg, vg, causal, None,
                                                  0)
            with FlopCounterMode(display=False) as fc:
                out.backward(torch.ones_like(out))
            assert fc.get_total_flops() == \
                costprobe.attention_backward_flops(q.shape, k.shape)
    assert costprobe.attention_flops((1, 4, 1, 1), (1, 4, 1, 1)) == 4 * 10
    assert costprobe.flash_pairs(4, 4, True, 2, 0) == 7


def test_live_count_adds_the_kernel_formula_at_each_launch(monkeypatch):
    """``costprobe.live_count`` (phase 19's live count on the card) adds
    the flash kernel's forward formula at each launch to what
    FlopCounterMode sees, and puts the wrapper back on exit, also after
    an error.  The launch here is a stub that counts no FLOPs of its own,
    so the total is the formula's."""
    def stub(q, k, v, causal=True, window=None, q_offset=0):
        return torch.zeros_like(q)

    monkeypatch.setattr(flash_cuda, "flash_attention", stub)
    shapes = (((2, 24, 4, 8), (2, 24, 2, 8), dict(causal=True)),
              ((1, 8, 2, 16), (1, 40, 1, 16),
               dict(causal=True, window=6, q_offset=32)))
    with costprobe.live_count() as live:
        for qs, ks, kw in shapes:
            flash_cuda.flash_attention(torch.ones(qs), torch.ones(ks),
                                       torch.ones(ks), **kw)
        torch.ones(3, 5) @ torch.ones(5, 7)
    want = sum(costprobe.attention_flops(qs, ks, **kw)
               for qs, ks, kw in shapes)
    assert live == dict(flops=want + 2 * 3 * 5 * 7, kernel_flops=want,
                        launches=2)
    assert flash_cuda.flash_attention is stub
    with pytest.raises(RuntimeError):
        with costprobe.live_count():
            raise RuntimeError("a step that fails")
    assert flash_cuda.flash_attention is stub


def test_cost_exact_gives_the_references_loss():
    """A ``cost_exact`` config (the reference's cost-probe mode, every
    scan unrolled and the loss in one chunk) builds, and its loss and
    gradients equal the reference's under the same flag."""
    from test_torch_train import (_batch, _close_grads, _pair, _port_grads,
                                  _ref_loss_and_grads)
    ref_model, params, model = _pair("qwen2.5-3b", cost_exact=True)
    assert model.cfg.cost_exact
    batch = _batch(model.cfg)
    want, want_g = _ref_loss_and_grads(ref_model, params, batch)
    _, metrics, grads = _port_grads(model, batch)
    for key in ("loss", "ce"):
        assert float(metrics[key]) == pytest.approx(float(want[key]),
                                                    rel=1e-5)
    _close_grads(model.cfg, grads, want_g)


def test_hillclimb_measure_and_expert_data_variant():
    """``hillclimb.run_variants`` (``measure`` of each variant) on a smoke
    prefill cell of a fake (2, 2) mesh: the baseline's record gives
    every ``Roofline.as_dict`` key beside the memory; the serve set's
    ``expert_data`` variant (MOE_SERVE_RULES) records the same keys, no
    error, and the all-to-all bytes of its token exchange: a rank
    receives (B_l rows x E experts x capacity slots x D) bf16 twice a
    MoE layer."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b-smoke")
    case = ShapeCase("p", "prefill", 16, 4)
    mesh = _fake_mesh()
    try:
        recs = hillclimb.run_variants(
            cfg, case, mesh,
            [v for v in hillclimb.VARIANTS["serve"]
             if v[0] in ("baseline(auto rules)", "expert_data(a2a tokens)")])
    finally:
        dist.destroy_process_group()
    keys = set(rl.Roofline(1, 1, 1, {}, 1).as_dict())
    base, a2a = recs
    for rec in recs:
        assert set(rec) == keys | {"variant", "temp_gib", "arg_gib",
                                   "peak_gib"}
    assert base["flops_per_device"] > 0 and base["arg_gib"] > 0
    assert base["collectives"]["all-to-all"] == 0
    E, K, D = cfg.n_experts, cfg.top_k, cfg.d_model
    cap = max(1, int(case.seq * K * cfg.capacity_factor / E))
    b_l = case.batch // 2
    n_moe = cfg.layer_kinds().count("moe")
    assert a2a["collectives"]["all-to-all"] == \
        2 * n_moe * b_l * E * cap * D * 2
    assert a2a["collective_bytes_per_device"] >= \
        a2a["collectives"]["all-to-all"]
