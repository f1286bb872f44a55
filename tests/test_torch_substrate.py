"""The training substrate: optimizer, data pipeline, checkpointing, fault
runtime and sharding rules, against the reference's (``tests/
test_substrate.py``'s cases, run on both packages).

Tolerances: the AdamW and schedule values are fp32 arithmetic of the
same terms in the same order, so 1e-6 relative; the partition specs,
rule tables, data and checkpoint contents must be equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as RefCheckpointManager
from repro.configs import get_arch as ref_get_arch
from repro.data import tokens as ref_tokens
from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.runtime.fault import PreemptionGuard as RefGuard
from repro.runtime.fault import StragglerWatch as RefWatch
from repro.sharding import rules as ref_rules
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import tokens
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import restore_for_mesh
from repro_torch.runtime.fault import PreemptionGuard, StragglerWatch, retry
from repro_torch.sharding import rules
from repro_torch.train.train_step import init_train_state
from test_torch_lm import NAMES


# --- optimizer -------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    """60 steps on |w|^2 from (3, -2), as the reference's test, and the
    same iterates as the reference's update."""
    kw = dict(lr=0.1, warmup_steps=0, decay_steps=100, weight_decay=0.0)
    ref_params = {"w": jnp.asarray([3.0, -2.0])}
    ref_state = ref_adamw.init_state(ref_params)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(params)
    for _ in range(60):
        ref_params, ref_state, _ = ref_adamw.update(
            ref_adamw.OptConfig(**kw), ref_params,
            {"w": 2 * ref_params["w"]}, ref_state)
        params, state, _ = adamw.update(adamw.OptConfig(**kw), params,
                                        {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.2
    np.testing.assert_allclose(params["w"].numpy(),
                               np.asarray(ref_params["w"]), rtol=1e-6)
    assert int(state["step"]) == int(ref_state["step"]) == 60


def test_schedule_warmup_and_decay():
    cfg = adamw.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                          min_lr_ratio=0.1)
    assert float(adamw.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(adamw.schedule(cfg, 10)) == pytest.approx(1.0, rel=1e-2)
    assert float(adamw.schedule(cfg, 100)) == pytest.approx(0.1, rel=1e-2)
    ref_cfg = ref_adamw.OptConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, 130, dtype=np.int32)
    np.testing.assert_allclose(
        adamw.schedule(cfg, torch.from_numpy(steps)).numpy(),
        np.asarray(ref_adamw.schedule(ref_cfg, jnp.asarray(steps))),
        rtol=1e-6)


def test_grad_clipping():
    """The norm before clipping is reported; m and v see the clipped
    gradient (norm 1), as in the reference."""
    cfg = adamw.OptConfig(lr=0.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(params)
    _, state, m = adamw.update(cfg, params, {"w": torch.tensor(
        [30., 40., 0.])}, state)
    assert float(m["grad_norm"]) == pytest.approx(50.0)
    assert torch.equal(params["w"], torch.zeros(3))
    ref_params = {"w": jnp.zeros(3)}
    _, ref_state, _ = ref_adamw.update(
        ref_adamw.OptConfig(lr=0.0, clip_norm=1.0), ref_params,
        {"w": jnp.asarray([30., 40., 0.])}, ref_adamw.init_state(ref_params))
    for key in ("m", "v"):
        np.testing.assert_allclose(state[key]["w"].numpy(),
                                   np.asarray(ref_state[key]["w"]), rtol=1e-6)
    np.testing.assert_allclose(state["m"]["w"].numpy(), [0.06, 0.08, 0.0],
                               rtol=1e-6)


def test_weight_decay_reaches_every_parameter():
    """Decay applies to norms and biases too (the reference's ``upd``
    decays every leaf): a zero gradient still shrinks a scale of ones."""
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    params = {"scale": torch.ones(4), "bias": torch.full((2,), 2.0)}
    state = adamw.init_state(params)
    adamw.update(cfg, params, {k: torch.zeros_like(v)
                               for k, v in params.items()}, state)
    lr = float(adamw.schedule(cfg, 1))
    torch.testing.assert_close(params["scale"],
                               torch.full((4,), 1 - lr * 0.5))
    torch.testing.assert_close(params["bias"],
                               torch.full((2,), 2 - lr * 0.5 * 2))


# --- data ------------------------------------------------------------------

def test_data_deterministic_sharded_and_equal_to_reference():
    cfg = tokens.DataConfig(vocab=97, seq_len=16, global_batch=8, seed=3)
    ref_cfg = ref_tokens.DataConfig(**dataclasses.asdict(cfg))
    for shard, n in ((0, 1), (0, 2), (1, 2)):
        got = tokens.batch_at(cfg, 5, shard=shard, num_shards=n)
        want = ref_tokens.batch_at(ref_cfg, 5, shard=shard, num_shards=n)
        for key in ("tokens", "targets"):
            np.testing.assert_array_equal(got[key], want[key])
    s0 = tokens.batch_at(cfg, 5, shard=0, num_shards=2)
    s1 = tokens.batch_at(cfg, 5, shard=1, num_shards=2)
    assert s0["tokens"].shape == (4, 16)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


# --- checkpointing -----------------------------------------------------------

def test_checkpoint_roundtrip_retention_and_resume(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2, async_save=False)
    state = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": state["a"] * step,
                        "b": {"c": state["b"]["c"] * step}})
    assert mgr.all_steps() == [2, 3]      # retention
    assert sorted(os.listdir(d)) == ["step_0000000002", "step_0000000003"]
    step, restored, extra = mgr.restore(state)
    assert step == 3 and extra == {}
    assert torch.equal(restored["a"], torch.arange(5) * 3)
    assert torch.equal(restored["b"]["c"], torch.full((2, 2), 3.0))
    step, restored, _ = mgr.restore(state, step=2)
    assert step == 2 and torch.equal(restored["a"], torch.arange(5) * 2)


def test_checkpoint_async_and_struct_restore(tmp_path):
    """An async save copies the state to the host before it returns (a
    later in-place write does not reach the file); a restore into shapes
    gives CPU tensors of the saved dtype, and a wrong shape raises."""
    d = str(tmp_path / "ck2")
    mgr = CheckpointManager(d, keep=1, async_save=True)
    w = torch.full((4,), 7.0)
    mgr.save(10, {"w": w, "step": torch.tensor(3, dtype=torch.int32)})
    w.fill_(-1.0)
    mgr.wait()
    step, restored, _ = mgr.restore({"w": torch.Size([4]),
                                     "step": torch.Size([])})
    assert step == 10 and float(restored["w"][0]) == 7.0
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 3
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.Size([5]), "step": torch.Size([])})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_checkpoint_keys_are_the_references(tmp_path):
    """Both managers join the nested names with ``||``: each restores the
    other's checkpoint into its own structure."""
    state = {"params": {"embed": {"tok": np.arange(6, dtype=np.float32)
                                  .reshape(2, 3)}},
             "opt": {"step": np.int32(4)}}
    ref_dir, port_dir = str(tmp_path / "r"), str(tmp_path / "p")
    ref = RefCheckpointManager(ref_dir, async_save=False)
    ref.save(4, jax.tree.map(jnp.asarray, state))
    step, got, _ = CheckpointManager(ref_dir).restore(state)
    assert step == 4
    np.testing.assert_array_equal(got["params"]["embed"]["tok"].numpy(),
                                  state["params"]["embed"]["tok"])
    port = CheckpointManager(port_dir, async_save=False)
    port.save(5, {"params": {"embed": {"tok": torch.from_numpy(
        state["params"]["embed"]["tok"])}}, "opt": {"step": torch.tensor(
            4, dtype=torch.int32)}})
    step, back, _ = RefCheckpointManager(port_dir).restore(
        jax.tree.map(jnp.asarray, state))
    assert step == 5 and int(back["opt"]["step"]) == 4
    np.testing.assert_array_equal(np.asarray(back["params"]["embed"]["tok"]),
                                  state["params"]["embed"]["tok"])


def test_restore_for_mesh_loads_onto_the_model(tmp_path):
    """The train state restores into the model's own parameters, with m,
    v and step on its device (restoring onto a mesh, as DTensors: see
    tests/test_torch_mesh.py); a second restore after the parameters
    moved puts the saved values back."""
    model = Model(get_arch("qwen2.5-3b-smoke"), device="cpu")
    state = init_train_state(model)
    for t in state["opt"]["m"].values():
        t.fill_(0.5)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(3, state)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.reset_parameters(torch.Generator().manual_seed(9))
    step, restored, _ = restore_for_mesh(mgr, model)
    assert step == 3
    for name, p in model.named_parameters():
        assert restored["params"][name] is p
        assert torch.equal(p, want[name])
        assert torch.equal(restored["opt"]["m"][name],
                           torch.full_like(p, 0.5))
    model.reset_parameters(torch.Generator().manual_seed(10))
    _, again, _ = restore_for_mesh(mgr, model, mesh=None)
    for name, p in model.named_parameters():
        assert again["params"][name] is p and torch.equal(p, want[name])


# --- fault runtime -----------------------------------------------------------

def test_straggler_watch_flags_slow_steps():
    """The same flags as the reference's watch on the same step times."""
    times = [0.1] * 10 + [1.0, 0.1, 0.5, 0.35, 0.29]
    w, ref = StragglerWatch(factor=3.0), RefWatch(factor=3.0)
    assert [w.observe(t) for t in times] == [ref.observe(t) for t in times]
    assert w.flagged == ref.flagged == 3


def test_preemption_guard_stop_request():
    for guard in (PreemptionGuard(), RefGuard()):
        assert not guard.should_stop
        guard.request_stop()
        assert guard.should_stop


def test_preemption_guard_uninstall_puts_back_the_handler():
    """SIGTERM while installed requests a stop; ``uninstall`` restores
    the handler that was there before."""
    import os
    import signal
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install()
    try:
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.should_stop
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


def test_retry_retries_transient_failures():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry(flaky, attempts=3, backoff_s=0.0) == "ok"
    assert len(calls) == 3


# --- sharding rules ----------------------------------------------------------

class _FakeMesh:
    """What the reference's rules read of a ``Mesh``: its axis names and
    its {axis: size} shape (no devices)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 16},
          {"pod": 2, "data": 8, "model": 16}]
RULE_SETS = [None, ref_rules.FSDP_RULES, ref_rules.MOE_FSDP_OUTDIM,
             ref_rules.MOE_SERVE_RULES]


def test_rule_tables_equal_the_references():
    for name in ("DEFAULT_RULES", "ACT_RULES", "FSDP_RULES",
                 "MOE_FSDP_OUTDIM", "MOE_SERVE_RULES"):
        assert getattr(rules, name) == getattr(ref_rules, name), name


def _leaves(logical, shapes, prefix=""):
    for key, sub in logical.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, shapes[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", sub, shapes[key].shape


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str,
                                                                 m.values())))
@pytest.mark.parametrize("name", NAMES)
def test_partition_specs_equal_the_references(name, mesh):
    """Every parameter of each dense arch, under each rule set, on the
    (data, model) and (pod, data, model) mesh shapes."""
    ref_model = RefModel(ref_get_arch(name))
    fake = _FakeMesh(mesh)
    n = 0
    for path, logical, shape in _leaves(ref_model.logical_axes(),
                                        ref_model.param_shapes()):
        for r in RULE_SETS:
            want = ref_rules.partition_spec(logical, shape, fake, r)
            got = rules.partition_spec(logical, shape, mesh, r)
            assert got == tuple(want), (path, r)
            n += 1
    assert n > 0


def test_batch_spec_divisibility():
    for mesh in MESHES:
        assert rules.batch_spec(mesh) == tuple(
            ref_rules.batch_spec(_FakeMesh(mesh)))
    real = jax.make_mesh((1, 1), ("data", "model"))
    for b in (1, 3, 8):
        assert rules.batch_sharding({"data": 1, "model": 1}, b) == tuple(
            ref_rules.batch_sharding(real, b).spec)
    mesh = {"pod": 2, "data": 8, "model": 16}
    assert rules.batch_sharding(mesh, 32) == (("pod", "data"),)
    assert rules.batch_sharding(mesh, 1) == ()      # replicated
    assert rules.batch_sharding({"data": 4, "model": 2}, 6) == ()
