"""Training over a device mesh on the CPU: four gloo ranks in fresh
processes (``python -c``, meeting through a file), a (data, model) mesh,
the train state placed by the logical-axis rules as DTensors.

One set of ranks (``_spawn``, started once for the module by the
``runs`` fixture) runs every case in turn: a rank runs :func:`worker`
on each case directory the fixture prepared, and rank 0 writes what the
ranks saw there.  The ranks import only the port; the comparisons with
the port's one-process step and the JAX reference's step run here, in
the test's process."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=30)
CHUNK = 8


# --- the ranks ----------------------------------------------------------------

def _batch(cfg, seed, b=8, t=16):
    from repro_torch.data.tokens import DataConfig, batch_at
    return batch_at(DataConfig(vocab=cfg.vocab, seq_len=t, global_batch=b,
                               seed=seed), 0)


def _case_batch(cfg, case, seed):
    return _batch(cfg, seed, t=case.get("seq", 16))


def _model(case):
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_arch(case["arch"]),
                              dtype_compute="float32")
    model = Model(cfg, device="cpu")
    model.loss_chunk = CHUNK
    return model


def _mesh(shape):
    """A (data, model) mesh, or (pod, data, model) of three sizes."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(
        "cpu", tuple(shape),
        mesh_dim_names=("pod", "data", "model")[3 - len(shape):])


def _full(tree):
    """Whole copies (a replicated DTensor's full tensor is its local one,
    which later steps write in place)."""
    return {k: v.detach().full_tensor().numpy().copy()
            for k, v in tree.items()}


def worker(rank: int, world: int, work: str) -> None:
    """One rank: join the group once, then run each case directory that
    ``work/cases.json`` lists (:func:`run_case`)."""
    import torch.distributed as dist
    work = Path(work)
    dist.init_process_group("gloo", init_method=f"file://{work / 'pg'}",
                            rank=rank, world_size=world)
    for name in json.loads((work / "cases.json").read_text()):
        run_case(rank, work / name)
        dist.barrier()
    dist.destroy_process_group()


def run_case(rank: int, work: Path) -> None:
    """Restore the case's checkpoint onto its mesh, take its steps, and
    (elastic cases) save, restore onto the second mesh and take one more
    step there."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.elastic import restore_for_mesh
    from repro_torch.train.train_step import TrainConfig, make_train_step
    case = json.loads((work / "case.json").read_text())
    model = _model(case)
    mesh = _mesh(case["mesh"])
    if "decode" in case:
        return _decode_worker(rank, model, mesh, case, work)
    if case.get("moe"):
        return _moe_worker(rank, model, mesh, case, work)
    if case.get("serve"):
        return _moe_serve_worker(rank, model, mesh, case, work)
    ckpt = CheckpointManager(str(work / "ckpt"), async_save=False)
    _, state, _ = restore_for_mesh(ckpt, model, mesh)
    leaves = list(state["params"].values()) + [
        t for key in ("m", "v") for t in state["opt"][key].values()] + [
        state["opt"]["step"]]
    out = {"state_bytes": sum(local_bytes(t) for t in leaves),
           "placements": {n: str(p.placements)
                          for n, p in state["params"].items()}}
    tcfg = TrainConfig(microbatches=case["mb"], opt=OptConfig(**OPT))
    step = make_train_step(model, tcfg, mesh)
    out["loss"], out["grad_norm"] = [], []
    for seed in case["seeds"]:
        state, metrics = step(state, _case_batch(model.cfg, case, seed))
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    arrays = {f"p/{k}": v for k, v in _full(state["params"]).items()}
    if "elastic" in case:
        saved = CheckpointManager(str(work / "saved"), async_save=False)
        saved.save(len(case["seeds"]), state)
        state, metrics = step(state, _batch(model.cfg, case["elastic"]))
        out["straight"] = float(metrics["loss"])
        arrays.update({f"s/{k}": v
                       for k, v in _full(state["params"]).items()})
        mesh2 = _mesh(case["mesh2"])
        at, state, _ = restore_for_mesh(saved, model, mesh2)
        out["restored_at"] = at
        out["placements2"] = {n: str(p.placements)
                              for n, p in state["params"].items()}
        arrays.update({f"r/{k}": v
                       for k, v in _full(state["params"]).items()})
        arrays.update({f"r{key}/{k}": v for key in ("m", "v")
                       for k, v in _full(state["opt"][key]).items()})
        step2 = make_train_step(model, tcfg, mesh2)
        state, metrics = step2(state, _batch(model.cfg, case["elastic"]))
        out["elastic"] = float(metrics["loss"])
        arrays.update({f"e/{k}": v
                       for k, v in _full(state["params"]).items()})
    if rank == 0:
        np.savez(work / "params.npz", **arrays)
        (work / "out.json").write_text(json.dumps(out))


def _decode_worker(rank, model, mesh, case, work) -> None:
    """Prefill in one process, then the decode steps twice: in one process,
    and over the mesh with the parameters placed by the default rules and
    the caches as the dry-run places them (KV positions split over
    ``"model"``); rank 0 writes both runs' logits."""
    from repro_torch.launch.dryrun import cache_shardings
    from repro_torch.models.kvcache import pad_caches
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import place_parameters, \
        state_shardings
    batch = _batch(model.cfg, 5, b=4, t=12)
    steps = case["decode"]
    _, caches = model.prefill(batch)
    caches = pad_caches(model.cfg, caches, steps)
    tokens = torch.from_numpy(batch["tokens"][:, -1:]).long()
    pos0 = batch["tokens"].shape[1]
    mesh_caches = [{k: t.clone() for k, t in c.items()} for c in caches]
    want = []
    for i in range(steps):
        logits, caches = model.decode(caches, tokens, pos0 + i)
        want.append(logits.numpy())
    place_parameters(model, state_shardings(model, mesh)["params"])
    shapes = model.cache_shapes(4, pos0 + steps)
    placed = [{k: rules.place(t, sh[k]) for k, t in c.items()}
              for c, sh in zip(mesh_caches, cache_shardings(shapes, mesh))]
    got = []
    with model.spmd():
        for i in range(steps):
            logits, placed = model.decode(
                placed, rules.constrain_batch(tokens, mesh), pos0 + i)
            got.append(logits.full_tensor().numpy())
    if rank == 0:
        np.savez(work / "params.npz", want=np.stack(want),
                 got=np.stack(got))
        (work / "out.json").write_text(json.dumps({
            "k": str(placed[0]["k"].placements)}))


def local_mean_aux(cfg, probs, counts, n_choices):
    """A planted fault: the load-balance loss of each rank's own rows (its
    local means multiplied), claimed to be the batch's
    (``moe.balance_loss`` takes both means over the batch).  Phase 18 of
    ``chip_smoke.py`` plants this one on the card."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = probs.to_local()
    ce = counts.to_local() / (pl.shape[0] * pl.shape[1] * cfg.top_k)
    aux = cfg.router_aux_coef * cfg.n_experts * torch.sum(
        pl.mean(dim=(0, 1)) * ce)
    return DTensor.from_local(aux, probs.device_mesh,
                              [Replicate()] * probs.device_mesh.ndim,
                              run_check=False)


def _moe_worker(rank, model, mesh, case, work) -> None:
    """The MoE over the mesh (experts split over ``"model"``): serving
    first, from the model's seed-0 parameters (prefill and two decode
    steps in one process here, then with the parameters and caches
    placed by the default rules, as :func:`_decode_worker`); then,
    from the case's checkpoint, the loss, aux and every gradient
    (reduced to the parameters' placements) of one batch, the same
    forward with :func:`local_mean_aux` planted, and the case's steps.
    Rank 0 writes everything."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch.dryrun import cache_shardings
    from repro_torch.models import moe
    from repro_torch.models.kvcache import pad_caches
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.elastic import restore_for_mesh
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              place_parameters, reduce_grads,
                                              state_shardings)
    out, arrays = {}, {}
    batch = _batch(model.cfg, 5, b=4, t=12)
    want_pre, caches = model.prefill(batch)
    caches = pad_caches(model.cfg, caches, 2)
    tokens = torch.from_numpy(batch["tokens"][:, -1:]).long()
    pos0 = batch["tokens"].shape[1]
    mesh_caches = [{k: t.clone() for k, t in c.items()} for c in caches]
    want = []
    for i in range(2):
        logits, caches = model.decode(caches, tokens, pos0 + i)
        want.append(logits.numpy())
    place_parameters(model, state_shardings(model, mesh)["params"])
    shapes = model.cache_shapes(4, pos0 + 2)
    placed = [{k: rules.place(t, sh[k]) for k, t in c.items()}
              for c, sh in zip(mesh_caches, cache_shardings(shapes, mesh))]
    got = []
    with model.spmd():
        got_pre, _ = model.prefill(
            {"tokens": rules.constrain_batch(
                torch.from_numpy(batch["tokens"]).long(), mesh)})
        for i in range(2):
            logits, placed = model.decode(
                placed, rules.constrain_batch(tokens, mesh), pos0 + i)
            got.append(logits.full_tensor().numpy())
    arrays.update(want_pre=want_pre.numpy(),
                  got_pre=got_pre.full_tensor().numpy(),
                  want=np.stack(want), got=np.stack(got))

    model = _model(case)
    _, state, _ = restore_for_mesh(
        CheckpointManager(str(work / "ckpt"), async_save=False), model, mesh)
    out["placements"] = {n: str(p.placements)
                         for n, p in state["params"].items()}
    placed_batch = {k: rules.constrain_batch(torch.from_numpy(v), mesh)
                    for k, v in _batch(model.cfg, 9).items()}
    params = state["params"]
    with model.spmd():
        loss, metrics = model.loss(placed_batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = reduce_grads(grads, params.values())
        real = moe.balance_loss
        moe.balance_loss = local_mean_aux
        try:
            with torch.no_grad():
                _, faulty = model.loss(placed_batch)
        finally:
            moe.balance_loss = real
    out["loss0"] = float(metrics["loss"].full_tensor())
    out["aux0"] = float(metrics["aux"].full_tensor())
    out["fault_aux"] = float(faulty["aux"].full_tensor())
    arrays.update({f"g/{n}": g.full_tensor().numpy().copy()
                   for n, g in zip(params, grads)})
    step = make_train_step(model, TrainConfig(microbatches=case["mb"],
                                              opt=OptConfig(**OPT)), mesh)
    out["loss"], out["grad_norm"] = [], []
    for seed in case["seeds"]:
        state, metrics = step(state, _case_batch(model.cfg, case, seed))
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    arrays.update({f"p/{k}": v for k, v in _full(state["params"]).items()})
    if rank == 0:
        np.savez(work / "params.npz", **arrays)
        (work / "out.json").write_text(json.dumps(out))


def greedy(model, batch, steps, mesh=None):
    """``serve_step.greedy_logits`` of ``batch`` and ``steps`` decode
    steps, over ``mesh`` when given: (the prefill's logits, each step's,
    the tokens), whole."""
    from repro_torch.train.serve_step import greedy_logits
    tokens = torch.from_numpy(batch["tokens"]).long()
    with model.spmd():
        out = [t.detach() for t in greedy_logits(
            model, {"tokens": tokens}, steps, mesh)]
    return (out[0].numpy(), torch.stack(out[1:]).numpy(),
            torch.stack([t.argmax(-1) for t in out], 1).numpy())


def _moe_serve_worker(rank, model, mesh, case, work) -> None:
    """The MoE with its experts split over the data axes
    (MOE_SERVE_RULES: on a (2, 2) mesh each data rank holds E/2 experts,
    each model rank half of every expert's FFN width; on a (2, 2, 1) one
    each (pod, data) rank E/4), from the model's seed-0 parameters
    placed by ``dryrun.param_shardings``: greedy decoding of a batch of
    4 (split over the data axes: the tokens move by all-to-all) and of a
    batch of 1 (no token moves), one MoE layer on its own, and, when
    the case has ``seeds``, the case's steps from its checkpoint placed
    by the same rules.  Rank 0 writes everything."""
    from repro_torch.launch.dryrun import param_shardings
    from repro_torch.models import moe
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import place_parameters
    serve = rules.MOE_SERVE_RULES
    place_parameters(model, param_shardings(model, mesh, serve))
    arrays, out = {}, {}
    moe.exchanged_bytes = 0
    for key, b in (("", 4), ("one_", 1)):
        pre, steps, toks = greedy(
            model, _batch(model.cfg, 5, b=b, t=12), case["serve"], mesh)
        arrays.update({f"{key}pre": pre, f"{key}steps": steps,
                       f"{key}toks": toks})
        out[f"{key}bytes"] = moe.exchanged_bytes
        moe.exchanged_bytes = 0
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 12, model.cfg.d_model)).astype(np.float32))
    with torch.no_grad(), model.spmd():
        y, aux = moe.moe_ffn(model.cfg, model.blocks[0]["moe"],
                             rules.constrain_batch(x, mesh))
    arrays.update(x=x.numpy(), y=y.full_tensor().numpy(),
                  aux=aux.full_tensor().numpy())
    out["placements"] = {n: str(p.placements)
                         for n, p in model.named_parameters()}
    if "seeds" in case:
        _moe_serve_steps(model, mesh, case, work, arrays, out)
    if rank == 0:
        np.savez(work / "params.npz", **arrays)
        (work / "out.json").write_text(json.dumps(out))


def _moe_serve_steps(model, mesh, case, work, arrays, out) -> None:
    """The case's train steps under MOE_SERVE_RULES from its checkpoint:
    the losses and grad norms into ``out``, the parameters into
    ``arrays``."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.elastic import restore_for_mesh
    from repro_torch.sharding import rules
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              place_train_state,
                                              state_shardings)
    serve = rules.MOE_SERVE_RULES
    model = _model(case)
    _, state, _ = restore_for_mesh(
        CheckpointManager(str(work / "ckpt"), async_save=False), model)
    state = place_train_state(model, state, mesh,
                              state_shardings(model, mesh, serve))
    step = make_train_step(model, TrainConfig(microbatches=case["mb"],
                                              opt=OptConfig(**OPT)), mesh)
    out["loss"], out["grad_norm"] = [], []
    for seed in case["seeds"]:
        state, metrics = step(state, _case_batch(model.cfg, case, seed))
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    arrays.update({f"p/{k}": v for k, v in _full(state["params"]).items()})


def _spawn(work: Path, cases: list, timeout: int = 240) -> list:
    """Four ranks running ``cases`` (directories of ``work``, each with its
    ``case.json``) in turn; the ranks' output tails when one failed."""
    (work / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}"
               f"{ROOT / 'tests'}", OMP_NUM_THREADS="1")
    code = ("import sys, test_torch_mesh as t; "
            "t.worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(WORLD), str(work)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [f"rank {r} exited {p.returncode}:\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]


# --- the tests' side ------------------------------------------------------------

def _save_state(work: Path, state) -> None:
    from repro_torch.checkpoint.ckpt import CheckpointManager
    CheckpointManager(str(work / "ckpt"), async_save=False).save(0, state)


def _one_process(case, state_np, seeds):
    """The port's unsharded step from the same state: (losses, grad
    norms, params as numpy)."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.train_step import (TrainConfig, load_train_state,
                                              make_train_step)
    model = _model(case)
    state = load_train_state(model, state_np)
    step = make_train_step(model, TrainConfig(microbatches=case["mb"],
                                              opt=OptConfig(**OPT)))
    losses, norms = [], []
    for seed in seeds:
        state, metrics = step(state, _case_batch(model.cfg, case, seed))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, {k: v.detach().numpy()
                           for k, v in state["params"].items()}


def _stepped_state(case, seed=0):
    """A train state after one one-process step (moments not zero: a
    first AdamW step moves an element by about lr * sign(g), whatever
    the size of g, so the zero-initialised biases' near-zero gradients
    would make it ill-conditioned to compare)."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)
    model = _model(case)
    state = init_train_state(model)
    state, _ = make_train_step(model, TrainConfig(opt=OptConfig(**OPT)))(
        state, _batch(model.cfg, seed))
    return model, state


# the key bias's gradient is 0 in exact arithmetic (adding one vector to
# every key shifts a query's scores by a constant, which the softmax
# drops), so its AdamW update is rounding noise scaled to the step size:
# both runs' values stay within two steps (2 * lr) of each other
NOISE = ("attn.bk",)


def _close(got: dict, want: dict, prefix: str, rtol: float) -> None:
    for name, w in want.items():
        g = got[f"{prefix}/{name}"]
        if name.endswith(NOISE):
            assert np.abs(g - w).max() <= 2 * OPT["lr"], name
            continue
        den = max(float(np.linalg.norm(w)), 1e-30)
        assert float(np.linalg.norm(g - w)) / den <= rtol, name


# the cases the ranks run: the reference's mesh step (minitron-8b-smoke,
# microbatches 2, from the JAX reference's state), a GQA model whose KV
# heads do not divide the model axis, RWKV-6's chunked time mix over
# three chunks (the last padded), decode over a mesh, the MoE with its
# experts split over "model" (E = 4, top 2), the MoE served with its
# experts split over "data" (MOE_SERVE_RULES) and over "pod" and "data"
# (a (2, 2, 1) mesh: one exchange group of the four ranks, flattened),
# and an elastic restore onto another mesh
CASES = {
    "step": {"arch": "minitron-8b-smoke", "mesh": [2, 2], "mb": 2,
             "seeds": [10, 11]},
    "gqa": {"arch": "qwen2.5-3b-smoke", "mesh": [1, 4], "mb": 1,
            "seeds": [3]},
    "rwkv": {"arch": "rwkv6-7b-smoke", "mesh": [2, 2], "mb": 2,
             "seeds": [4, 5], "seq": 72},
    "decode": {"arch": "qwen2.5-3b-smoke", "mesh": [2, 2], "decode": 2},
    "moe": {"arch": "phi3.5-moe-42b-a6.6b-smoke", "mesh": [2, 2], "mb": 1,
            "seeds": [6, 7], "moe": True},
    "moe_serve": {"arch": "qwen3-moe-235b-a22b-smoke", "mesh": [2, 2],
                  "mb": 1, "seeds": [8], "serve": 2},
    "moe_serve_pod": {"arch": "qwen3-moe-235b-a22b-smoke",
                      "mesh": [2, 2, 1], "serve": 2},
    "elastic": {"arch": "qwen2.5-3b-smoke", "mesh": [2, 2], "mb": 2,
                "seeds": [1, 2], "elastic": 3, "mesh2": [4, 1]},
}


def _reference_state(case):
    """The JAX reference's train state for ``case`` (parameters redrawn
    from a seed) and the port's copy of it."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as ref_get_arch
    from repro.models import Model as RefModel
    from repro.optim import adamw as ref_adamw
    from repro_torch.convert import train_state_from_reference
    from test_torch_lm import _redraw
    rcfg = dataclasses.replace(ref_get_arch(case["arch"]),
                               dtype_compute="float32")
    params = _redraw(jax.tree.map(np.asarray, RefModel(rcfg).init(
        jax.random.PRNGKey(0))), np.random.default_rng(5))
    ref_state = {"params": jax.tree.map(jnp.asarray, params),
                 "opt": ref_adamw.init_state(params)}
    state = train_state_from_reference(
        _model(case).cfg, jax.tree.map(np.asarray, ref_state))
    return rcfg, ref_state, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of CASES run by one set of ranks: {name: (directory,
    the train state it started from)}, and the ranks' failures."""
    work = tmp_path_factory.mktemp("mesh")
    states = {}
    for name, case in CASES.items():
        (work / name).mkdir()
        (work / name / "case.json").write_text(json.dumps(case))
        if "seeds" not in case:
            continue
        if name == "step":
            states[name] = _reference_state(case)
            state = states[name][2]
        else:
            state = states[name] = _stepped_state(case)[1]
        _save_state(work / name, state)
    failed = _spawn(work, list(CASES))
    return {name: work / name for name in CASES}, states, failed


def _result(runs, name):
    """A case's directory and rank 0's record of it (failing with the
    ranks' output when the case left none)."""
    dirs, _, failed = runs
    out = dirs[name] / "out.json"
    assert out.exists(), "\n".join(failed) or f"{name}: no record"
    return dirs[name], json.loads(out.read_text())


def test_mesh_step_matches_one_process_and_reference(runs):
    """The reference's ``test_sharded_train_step_runs_on_mesh`` case
    (minitron-8b-smoke, microbatches 2) on a (2, 2) mesh of gloo ranks,
    two steps: loss, grad norm and every updated parameter equal the
    port's one-process step's within 1e-5 relative (fp32 compute), and
    the JAX reference's jitted step from the same state (carried across
    by ``convert.train_state_from_reference``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import Model as RefModel
    from repro.optim.adamw import OptConfig as RefOptConfig
    from repro.train.train_step import TrainConfig as RefTrainConfig
    from repro.train.train_step import make_train_step as ref_step_fn
    from repro_torch.convert import train_state_from_reference

    case = CASES["step"]
    work, out = _result(runs, "step")
    rcfg, ref_state, state = runs[1]["step"]
    model = _model(case)
    got = dict(np.load(work / "params.npz"))

    losses, norms, want = _one_process(case, state, case["seeds"])
    np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-5)
    _close(got, want, "p", 1e-5)
    # the default rules split heads, kv heads, mlp and vocab over model
    assert out["placements"]["blocks.0.attn.wq"] == \
        "(Replicate(), Shard(dim=1))"
    assert out["placements"]["unembed.w"] == "(Replicate(), Shard(dim=1))"

    ref_step = jax.jit(ref_step_fn(
        RefModel(rcfg, loss_chunk=CHUNK),
        RefTrainConfig(microbatches=2, opt=RefOptConfig(**OPT))))
    for i, seed in enumerate(case["seeds"]):
        batch = {k: jnp.asarray(v)
                 for k, v in _batch(model.cfg, seed).items()}
        ref_state, metrics = ref_step(ref_state, batch)
        np.testing.assert_allclose(out["loss"][i], float(metrics["loss"]),
                                   rtol=1e-5)
    ref = train_state_from_reference(model.cfg,
                                     jax.tree.map(np.asarray, ref_state))
    _close(got, {k: v.numpy() for k, v in ref["params"].items()}, "p",
           1e-4)

    # the dry-run of the same state on a fake group of four ranks counts
    # the bytes each gloo rank holds
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCase
    dryrun.fake_group(WORLD)
    try:
        mem = dryrun.run_cell(model.cfg, ShapeCase("mesh", "train", 16, 8),
                              _mesh(case["mesh"]), microbatches=2,
                              fsdp="tp")
    finally:
        dist.destroy_process_group()
    assert mem["argument_bytes"] - mem["batch_bytes"] == out["state_bytes"]
    assert mem["batch_bytes"] == 2 * (8 // 2) * 16 * 4   # int32 tokens, targets


def _matches_one_process(runs, name):
    case = CASES[name]
    work, out = _result(runs, name)
    losses, norms, want = _one_process(case, runs[1][name], case["seeds"])
    np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-5)
    _close(dict(np.load(work / "params.npz")), want, "p", 1e-5)
    return out


def test_gqa_kv_heads_that_do_not_divide_the_model_axis(runs):
    """qwen2.5-3b-smoke (4 query heads over 2 KV heads) on a (1, 4) mesh:
    the rules replicate k and v, each rank reads the KV group of its one
    query head; a step equals the one-process step."""
    out = _matches_one_process(runs, "gqa")
    assert out["placements"]["blocks.0.attn.wk"] == "(Replicate(), " \
        "Replicate())"
    assert out["placements"]["blocks.0.attn.wq"] == "(Replicate(), " \
        "Shard(dim=1))"


def test_rwkv_time_mix_over_a_mesh_matches_one_process(runs):
    """rwkv6-7b-smoke (4 heads) on a (2, 2) mesh, 72 tokens (three chunks
    of 32, the last padded), microbatches 2: the chunked time mix runs
    on each rank's rows and two heads (``rwkv6._on_local_heads``), and
    two steps' losses, grad norms and parameters equal the one-process
    steps' within 1e-5 relative (fp32)."""
    _matches_one_process(runs, "rwkv")


def test_decode_over_a_mesh_matches_one_process(runs):
    """Two decode steps of qwen2.5-3b-smoke after a 12-token prefill, over
    a (2, 2) mesh with each layer's KV cache split by position over
    ``"model"`` and by row over ``"data"`` (the dry-run's placement): the
    logits equal one process's (fp32), each step writing its key and
    value on the rank that holds the slot."""
    work, out = _result(runs, "decode")
    assert out["k"] == "(Shard(dim=0), Shard(dim=1))"
    got = np.load(work / "params.npz")
    np.testing.assert_allclose(got["got"], got["want"], rtol=1e-5,
                               atol=1e-5)


def test_moe_over_a_mesh_matches_one_process(runs):
    """phi3.5-moe-smoke (E = 4, top 2, 2 layers) on a (2, 2) mesh, each
    model rank holding 2 experts: the loss, ``aux`` and every gradient
    (the router's included: each rank's share of it comes from its own
    experts' gates and is summed over ``"model"``) of one batch, and two
    AdamW steps' losses, auxes, grad norms and parameters, equal the
    one-process port's within 1e-5 (fp32; each step's loss holds its
    aux); so do the prefill logits and
    two decode steps' under the default (TP) rules.  The load-balance
    loss from each rank's own means (:func:`local_mean_aux`) reads off
    by more than that bound."""
    from repro_torch.train.train_step import load_train_state
    case = CASES["moe"]
    work, out = _result(runs, "moe")
    got = dict(np.load(work / "params.npz"))
    for key in ("pre", ""):
        np.testing.assert_allclose(got[f"got{key and '_' + key}"],
                                   got[f"want{key and '_' + key}"],
                                   rtol=1e-5, atol=1e-5)
    assert out["placements"]["blocks.0.moe.wi"] == "(Replicate(), " \
        "Shard(dim=0))"
    model = _model(case)
    state = load_train_state(model, runs[1]["moe"])
    loss, metrics = model.loss(_batch(model.cfg, 9))
    grads = torch.autograd.grad(loss, list(state["params"].values()))
    np.testing.assert_allclose(out["loss0"], float(loss.detach()), rtol=1e-5)
    aux = float(metrics["aux"])
    np.testing.assert_allclose(out["aux0"], aux, rtol=1e-5)
    assert abs(out["fault_aux"] - aux) > 1e-5 * aux, out["fault_aux"]
    _close(got, {n: g.numpy() for n, g in zip(state["params"], grads)},
           "g", 1e-5)
    assert any(n.endswith("moe.router") for n in state["params"])
    losses, norms, want = _one_process(case, runs[1]["moe"], case["seeds"])
    np.testing.assert_allclose(out["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(out["grad_norm"], norms, rtol=1e-5)
    _close(got, want, "p", 1e-5)


def _serves_as_one_process(runs, name, d):
    """The ``_moe_serve_worker`` record of case ``name`` (its expert
    axes ``d`` ranks): the greedy runs of 4 rows and of 1 equal one
    process's within 1e-5 (fp32), with the same tokens; a rank received
    2 x layers x B_l x E x capacity x D x 4 bytes for the 4 rows (d
    ranks x B_l rows x E/d experts a call, two calls a layer, the
    prefill's capacity and then K a step), none for the 1; the MoE
    layer's mesh output and aux equal the JAX reference's ``moe_ffn`` on
    the same parameters and input.  (the record, the arrays)"""
    import jax.numpy as jnp
    from repro.configs import get_arch as ref_get_arch
    from repro.models import moe as ref_moe
    case = CASES[name]
    work, out = _result(runs, name)
    got = dict(np.load(work / "params.npz"))
    model = _model(case)
    cfg = model.cfg
    for key, b in (("", 4), ("one_", 1)):
        pre, steps, toks = greedy(model, _batch(cfg, 5, b=b, t=12),
                                  case["serve"])
        np.testing.assert_allclose(got[f"{key}pre"], pre, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[f"{key}steps"], steps, rtol=1e-5,
                                   atol=1e-5)
        assert np.array_equal(got[f"{key}toks"], toks)
    E, K, D, b_l, t = cfg.n_experts, cfg.top_k, cfg.d_model, 4 // d, 12
    caps = [max(1, int(t * K * cfg.capacity_factor / E))] \
        + [K] * case["serve"]
    assert out["bytes"] == sum(2 * cfg.n_layers * b_l * E * c * D * 4
                               for c in caps)
    assert out["one_bytes"] == 0

    rcfg = dataclasses.replace(ref_get_arch(case["arch"]),
                               dtype_compute="float32")
    p = {k: jnp.asarray(v.detach().numpy())
         for k, v in model.blocks[0].moe._parameters.items()}
    want, want_aux = ref_moe.moe_ffn(rcfg, p, jnp.asarray(got["x"]))
    np.testing.assert_allclose(got["y"], np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["aux"], float(want_aux), rtol=1e-5)
    return out


def test_moe_serve_rules_match_one_process_and_reference(runs):
    """qwen3-moe-smoke (E = 4, top 2, 2 layers) served on a (2, 2) mesh
    under MOE_SERVE_RULES (experts split over ``"data"``, their FFN
    width over ``"model"``): greedy decoding of 4 rows (two a data rank:
    the tokens travel to their experts by all-to-all) and of 1 row (no
    token moves) and one MoE layer as :func:`_serves_as_one_process`
    holds them; a train step under the same rules equals one
    process's."""
    out = _serves_as_one_process(runs, "moe_serve", 2)
    assert out["placements"]["blocks.0.moe.wi"] == \
        "(Shard(dim=0), Shard(dim=2))"
    assert out["placements"]["blocks.0.moe.wo"] == \
        "(Shard(dim=0), Shard(dim=1))"
    _matches_one_process(runs, "moe_serve")


def test_moe_serve_rules_over_pod_and_data_match_one_process(runs):
    """The same model on a (pod 2, data 2, model 1) mesh: the experts
    split over ``"pod"`` and ``"data"``, one each, exchanged over the
    flattened group of the four ranks (pod-major, the experts' order),
    one row a rank; served as :func:`_serves_as_one_process` holds it."""
    out = _serves_as_one_process(runs, "moe_serve_pod", 4)
    assert out["placements"]["blocks.0.moe.wi"].startswith(
        "(Shard(dim=0), Shard(dim=0), ")


def test_kv_group_keeps_the_head_map():
    """``ops.kv_group``: query head h0 + i reads KV head (h0 + i) // g."""
    from repro_torch.kernels.flash_attention.ops import kv_group
    for h, hkv in ((16, 2), (24, 6), (8, 8), (32, 8), (4, 2)):
        g = h // hkv
        for m in (1, 2, 4, 8, 16):
            if h % m:
                continue
            hl = h // m
            for r in range(m):
                sel = kv_group(h, hkv, r * hl, hl)
                heads = list(range(hkv))[sel] if isinstance(sel, slice) \
                    else sel
                per = hl // len(heads)
                assert hl % len(heads) == 0
                assert [heads[i // per] for i in range(hl)] == [
                    (r * hl + i) // g for i in range(hl)], (h, hkv, m, r)


def test_elastic_restore_onto_another_mesh(runs):
    """The reference's ``test_elastic_restore_different_mesh``: a state
    saved after two steps under (2, 2) restores under (4, 1) with every
    parameter, ``m`` and ``v`` bit-equal to the saved ones, and step 3
    there equals step 3 taken straight on under (2, 2)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    work, out = _result(runs, "elastic")
    state = runs[1]["elastic"]
    got = dict(np.load(work / "params.npz"))
    assert out["restored_at"] == 2
    # a model axis of 1: the default rules split nothing
    assert set(out["placements2"].values()) == {"(Replicate(), "
                                                "Replicate())"}
    _, saved, _ = CheckpointManager(str(work / "saved")).restore(
        {"params": {k: v.shape for k, v in state["params"].items()},
         "opt": {"m": {k: v.shape for k, v in state["params"].items()},
                 "v": {k: v.shape for k, v in state["params"].items()},
                 "step": ()}})
    for name, p in saved["params"].items():
        assert np.array_equal(got[f"r/{name}"], p.numpy()), name
        assert np.array_equal(got[f"p/{name}"], p.numpy()), name
        for key in ("m", "v"):
            assert np.array_equal(got[f"r{key}/{name}"],
                                  saved["opt"][key][name].numpy())
    np.testing.assert_allclose(out["elastic"], out["straight"], rtol=1e-5)
    _close(got, {k: got[f"s/{k}"] for k in saved["params"]}, "e", 1e-5)


def test_launcher_trains_over_a_mesh(tmp_path):
    """``launch/train.py --model-parallel 2 --device cpu`` under
    ``torchrun`` with 4 processes: a (2, 2) mesh that resumes from the
    checkpoint a one-process run of the launcher left at step 6
    (restored whole, then placed on the mesh), and the loss falls over
    the two runs."""
    from repro_torch.launch import train as launcher
    args = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "8", "--seq",
            "16", "--microbatches", "2", "--device", "cpu", "--ckpt-every",
            "6", "--ckpt-dir", str(tmp_path / "ck")]
    first = launcher.main(args + ["--steps", "6"])["loss"][0]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train"]
        + args + ["--steps", "12", "--model-parallel", "2"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh DeviceMesh((data=2, model=2)" in out.stdout
    assert "[resume] restored checkpoint at step 6" in out.stdout
    done = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[train] done")]
    assert len(done) == 1
    last = float(done[0].split("loss ")[1].split(" -> ")[1])
    assert last < first
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_0000000006", "step_0000000012"]


# --- attention on a rank's own heads ------------------------------------------

# (B, T, H, Hkv, Dh, model axis): KV heads split with the query heads;
# KV heads that do not divide the axis (replicated; a rank's query heads
# in one KV group, in whole groups, or straddling two)
HEAD_CASES = [(2, 64, 8, 2, 16, 2), (1, 48, 4, 2, 16, 4),
              (2, 64, 16, 2, 32, 4), (1, 40, 12, 3, 16, 2),
              (1, 32, 24, 6, 16, 4)]


def local_heads_check(dev, case, dtype, atol):
    """``ops.flash_attention`` of DTensors on a (1, m) mesh, rank by rank
    (each rank of a fake group in turn: the local tensors are real, the
    collectives move nothing): each rank's output and q gradient equal
    the plain version's on all heads (``impl="chain"``), on its heads;
    its k and v gradients, summed over the ranks that replicate k and v,
    equal the whole ones."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.kernels.flash_attention import ops
    b, t, h, hkv, dh, m = case
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(b, t, n, dh, generator=gen).to(dev, dtype)
               for n in (h, hkv, hkv))
    go = torch.randn(b, t, h, dh, generator=gen).to(dev, dtype)
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))
    want = ops.flash_attention(qf, kf, vf, impl="chain")
    want.backward(go)
    hl, split = h // m, hkv % m == 0
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    for r in range(m):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=m)
        try:
            mesh = init_device_mesh(dev.type, (1, m),
                                    mesh_dim_names=("data", "model"))
            heads = slice(r * hl, (r + 1) * hl)
            kv = slice(r * hkv // m, (r + 1) * hkv // m) if split \
                else slice(None)
            where = [Replicate(), Shard(2)]
            kv_where = where if split else [Replicate(), Replicate()]
            ql = q[:, :, heads].clone().requires_grad_()
            kl = k[:, :, kv].clone().requires_grad_()
            vl = v[:, :, kv].clone().requires_grad_()
            out = ops.flash_attention(
                DTensor.from_local(ql, mesh, where, run_check=False),
                DTensor.from_local(kl, mesh, kv_where, run_check=False),
                DTensor.from_local(vl, mesh, kv_where, run_check=False),
                impl="fused")
            assert out.placements[1] == Shard(2)    # the heads stay split
            local = out.to_local()
            torch.testing.assert_close(local, want[:, :, heads].detach(),
                                       atol=atol, rtol=atol)
            local.backward(go[:, :, heads])
            torch.testing.assert_close(ql.grad, qf.grad[:, :, heads],
                                       atol=atol, rtol=atol)
            dk[:, :, kv] += kl.grad.float()
            dv[:, :, kv] += vl.grad.float()
        finally:
            dist.destroy_process_group()
    torch.testing.assert_close(dk, kf.grad.float(), atol=atol, rtol=atol)
    torch.testing.assert_close(dv, vf.grad.float(), atol=atol, rtol=atol)


@pytest.mark.parametrize("case", HEAD_CASES, ids=str)
def test_attention_on_local_heads_matches_the_whole(case):
    local_heads_check(torch.device("cpu"), case, torch.float32, 2e-5)


# --- the MoE on a rank's own experts --------------------------------------------

def local_experts_check(dev, dtype, atol, m=2):
    """``moe.moe_ffn`` of DTensors on a (1, m) mesh, rank by rank (each
    rank of a fake group in turn: the local tensors are real, the
    collectives move nothing, so the router's weight is given whole):
    phi3.5-moe-smoke (4 experts, top 2) in ``dtype`` compute, each rank
    holding E/m experts.  Summed over the ranks, the outputs (each
    rank's experts' share) and the gradients of x and of the router
    equal the whole layer's; each rank's expert-weight gradients equal
    the whole layer's on its experts, and its aux loss the whole one."""
    import dataclasses as dc
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = dc.replace(get_arch("phi3.5-moe-42b-a6.6b-smoke"),
                     dtype_compute="float32" if dtype == torch.float32
                     else "bfloat16")
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff
    gen = torch.Generator().manual_seed(11)
    p = {"router": torch.randn(D, E, generator=gen) * 0.1,
         "wi": torch.randn(E, D, F, generator=gen) * 0.1,
         "wg": torch.randn(E, D, F, generator=gen) * 0.1,
         "wo": torch.randn(E, F, D, generator=gen) * 0.1}
    p = {k: v.to(dev) for k, v in p.items()}
    x = torch.randn(2, 24, D, generator=gen).to(dev, dtype)
    go = torch.randn(2, 24, D, generator=gen).to(dev, dtype)
    whole = {k: v.clone().requires_grad_() for k, v in p.items()}
    xw = x.clone().requires_grad_()
    want, want_aux = moe.moe_ffn(cfg, whole, xw)
    ((want * go).sum() + want_aux).backward()
    el = E // m
    out = torch.zeros_like(want, dtype=torch.float32)
    dx = torch.zeros_like(x, dtype=torch.float32)
    drouter = torch.zeros_like(p["router"])
    for r in range(m):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=m)
        try:
            mesh = init_device_mesh(dev.type, (1, m),
                                    mesh_dim_names=("data", "model"))
            rep, experts = [Replicate(), Replicate()], [Replicate(), Shard(0)]
            mine = slice(r * el, (r + 1) * el)
            loc = {"router": p["router"].clone().requires_grad_(),
                   **{k: p[k][mine].clone().requires_grad_()
                      for k in ("wi", "wg", "wo")}}
            xl = x.clone().requires_grad_()
            dp = {k: DTensor.from_local(v, mesh, rep if k == "router"
                                        else experts, run_check=False)
                  for k, v in loc.items()}
            got, aux = moe.moe_ffn(cfg, dp, DTensor.from_local(
                xl, mesh, rep, run_check=False))
            torch.testing.assert_close(aux.full_tensor(), want_aux.detach(),
                                       atol=atol, rtol=atol)
            local = got.to_local()
            ((local * go).sum() + aux.to_local() / m).backward()
            out += local.detach().float()
            dx += xl.grad.float()
            drouter += loc["router"].grad
            for k in ("wi", "wg", "wo"):
                torch.testing.assert_close(loc[k].grad, whole[k].grad[mine],
                                           atol=atol, rtol=atol)
        finally:
            dist.destroy_process_group()
    torch.testing.assert_close(out, want.detach().float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(dx, xw.grad.float(), atol=atol, rtol=atol)
    torch.testing.assert_close(drouter, whole["router"].grad, atol=atol,
                               rtol=atol)


def test_moe_on_local_experts_matches_the_whole():
    local_experts_check(torch.device("cpu"), torch.float32, 1e-5)
