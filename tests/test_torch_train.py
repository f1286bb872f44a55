"""LM training: the port's gradients, loss, train step, remat and loop
against the reference's.

The reference's parameters are ``Model.init(PRNGKey(0))`` with the QKV
biases and norm scales redrawn (``test_torch_lm._redraw``), carried
across with ``convert``; tokens, targets, masks and cotangents are
numpy draws from fixed seeds.  Everything runs in fp32 compute on the
CPU, where the port's attention under ``"fused"`` is the plain blocked
softmax (``plain.py``).

Tolerances (absolute and relative unless said otherwise):

  * attention gradients: 1e-4, the reference's own
    (``tests/test_kernels.py::test_flash_gradients_match_ref``): both sum
    the blocked softmax's backward in their own orders;
  * loss, ``ce``: 1e-5 relative; every parameter's gradient: 1e-4
    relative plus 1e-6 absolute (a gradient element is a sum over
    B·T positions and the vocabulary, summed in another order);
  * three AdamW steps: parameters 1e-5 absolute (an element whose
    gradient is near zero after cancellation moves by lr times its
    relative noise), ``m`` and ``v`` 1e-4 relative and 1e-6 / 1e-9
    absolute in fp32.  With bf16 gradients a gradient that lies near a
    bf16 rounding boundary rounds the other way in the reference, one
    bf16 step (2^-8 relative): ``m`` and ``v`` get 2^-7 relative, and
    the parameters 3e-5 absolute (such a step moves an update by up to
    lr·2^-8 times the m/sqrt(v) factor, about 2, on each of 3 steps at
    lr <= 1e-3: 2.3e-5);
  * the remat policies: 1e-6 between each other (the same ops, run
    again);
  * the loop: 1e-5 relative between a crash-resumed and a straight run
    of the port, 1e-4 relative against the reference's losses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data.tokens import DataConfig as RefDataConfig
from repro.kernels.flash_attention import ops as ref_ops
from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.train.loop import LoopConfig as RefLoopConfig
from repro.train.loop import train as ref_train
from repro.train.train_step import TrainConfig as RefTrainConfig
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.convert import (arch_config_from_reference,
                                 lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.kernels.flash_attention import cuda as flash_cuda
from repro_torch.kernels.flash_attention import ops, plain
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          load_train_state, make_train_step)
from test_torch_flash import BLOCKS, CASES, _inputs, _masks
from test_torch_lm import NAMES, _redraw

B, T = 2, 16
CHUNK = 8                     # loss_chunk of both models: two chunks at T


def _pair(name, **fields):
    """(reference model, reference params as numpy, port model on the
    CPU) in fp32 compute, both with ``loss_chunk = CHUNK``."""
    rcfg = dataclasses.replace(ref_get_arch(name + "-smoke"),
                               dtype_compute="float32", **fields)
    cfg = arch_config_from_reference(dataclasses.asdict(rcfg))
    params = _redraw(jax.tree.map(np.asarray, RefModel(rcfg).init(
        jax.random.PRNGKey(0))), np.random.default_rng(5))
    model = Model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, params))
    model.loss_chunk = CHUNK
    return RefModel(rcfg, loss_chunk=CHUNK), params, model


def _batch(cfg, t=T, b=B, seed=1, mask=False):
    out = batch_at(DataConfig(vocab=cfg.vocab, seq_len=t, global_batch=b,
                              seed=seed), 0)
    if mask:
        out["mask"] = (np.random.default_rng(seed).random((b, t)) > 0.3
                       ).astype(np.float32)
    return out


def _port_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, metrics = model.loss(batch)
    loss.backward()
    return loss, metrics, {n: p.grad for n, p in model.named_parameters()}


def _ref_loss_and_grads(ref_model, params, batch):
    fn = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    return metrics, jax.tree.map(np.asarray, grads)


def _close_grads(cfg, got, want_tree, rtol=1e-4, atol=1e-6):
    want = lm_params_from_reference(cfg, want_tree)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


# --- attention gradients ----------------------------------------------------

@pytest.mark.parametrize("impl", ["chain", "fused"])
def test_flash_gradients_match_ref(impl):
    """The reference's ``test_flash_gradients_match_ref`` on the port:
    the blocked path's q gradient (``"fused"`` runs it on a CPU tensor)
    equals the dense oracle's."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((2, 16, 4, 16)), dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.standard_normal((2, 16, 2, 16)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((2, 16, 2, 16)), dtype=torch.float32)
    g_ref, = torch.autograd.grad(
        ops.flash_attention(q, k, v, impl="ref").sum(), q)
    g, = torch.autograd.grad(ops.flash_attention(
        q, k, v, impl=impl, block_q=8, block_k=8).sum(), q)
    torch.testing.assert_close(g, g_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_flash_gradients_match_reference_xla(case):
    """q, k and v gradients of the port's blocked path against the
    reference's ``jax.grad`` of its XLA scan on its sweep, fp32, with a
    seeded cotangent."""
    q, k, v = _inputs(case)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda q, k, v: (ref_ops.flash_attention(
        q, k, v, impl="xla", **_masks(case), **BLOCKS) * w).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, impl="chain", **_masks(case),
                              **BLOCKS)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (qt, kt, vt))
    for what, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{what} {case}")


def test_plain_remats_each_block_under_autograd(monkeypatch):
    """With an input that requires grad, every q block and every kv step
    of the plain path runs under ``torch.utils.checkpoint`` (nested, as
    the reference's two ``jax.checkpoint``s); without, none does."""
    calls = []
    real = plain.checkpoint

    def spy(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(plain, "checkpoint", spy)
    case = CASES[3]                       # T = S = 32
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    plain.flash_attention(q, k, v, **_masks(case), **BLOCKS)
    assert calls == []
    out = plain.flash_attention(q.requires_grad_(), k, v, **_masks(case),
                                **BLOCKS)
    nq = nk = 32 // 8
    assert calls.count("q_block") == nq
    assert calls.count("kv_step") == nq * nk
    out.sum().backward()
    assert q.grad is not None


def test_fused_function_backward_differentiates_plain(monkeypatch):
    """``cuda.FlashAttention`` with the kernel's plain version in place of
    the launch (the arithmetic the kernel is held to): its output and its
    q, k, v gradients are the plain path's, its backward counts one
    ``backward_calls`` and no launch."""
    monkeypatch.setattr(flash_cuda, "flash_attention",
                        plain.flash_attention)
    case = CASES[7]
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 64, 16, 128)).astype(np.float32))
    grads = []
    for fused in (True, False):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in
                   _inputs(case))
        if fused:
            before = (flash_cuda.backward_calls, flash_cuda.launches)
            out = flash_cuda.FlashAttention.apply(q, k, v, True, None, 0)
        else:
            out = plain.flash_attention(q, k, v)
        grads.append(torch.autograd.grad((out * w).sum(), (q, k, v)))
        if fused:
            assert (flash_cuda.backward_calls, flash_cuda.launches) == (
                before[0] + 1, before[1])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- the loss -----------------------------------------------------------------

LOSS_CASES = {"chunks": dict(), "mask": dict(mask=True),
              "ragged": dict(t=12)}     # 12 % CHUNK != 0: one chunk of T


@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name, case):
    ref_model, params, model = _pair(name)
    batch = _batch(model.cfg, **LOSS_CASES[case])
    want, want_g = _ref_loss_and_grads(ref_model, params, batch)
    loss, metrics, grads = _port_grads(model, batch)
    assert loss.requires_grad and set(metrics) == {"loss", "ce", "aux",
                                                   "tokens"}
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(metrics[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(metrics["aux"]) == float(want["aux"]) == 0.0
    assert float(metrics["tokens"]) == float(want["tokens"])
    _close_grads(model.cfg, grads, want_g)


def test_loss_chunks_are_rematerialised(monkeypatch):
    """Each loss chunk's logits run under ``torch.utils.checkpoint`` when
    grad is enabled: T / loss_chunk chunks of (B, loss_chunk) positions,
    each computed again in backward; and the chunked loss equals one
    chunk of T."""
    _, _, model = _pair("qwen2.5-3b")
    batch = _batch(model.cfg)
    calls = []
    real = model._chunk_nll
    monkeypatch.setattr(model, "_chunk_nll",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    chunked, _ = model.loss(batch)
    assert calls == [(B, CHUNK, model.cfg.d_model)] * (T // CHUNK)
    chunked.backward()
    assert len(calls) == 2 * (T // CHUNK)
    model.loss_chunk = T
    whole, _ = model.loss(batch)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=0)


# --- remat ------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none", "full", "dots"])
def test_remat_policies_agree(policy, monkeypatch):
    """Each remat policy gives the reference's loss and gradients under
    the same policy, and the port's "none" ones within 1e-6; under
    "full" and "dots" each layer's attention runs again in backward
    (the layer is recomputed), under "none" it does not."""
    ref_model, params, model = _pair("qwen2.5-3b", remat_policy=policy)
    batch = _batch(model.cfg)
    calls = []
    real = layers.fa_ops.flash_attention
    monkeypatch.setattr(layers.fa_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss, _, grads = _port_grads(model, batch)
    n = model.cfg.n_layers
    assert len(calls) == (n if policy == "none" else 2 * n)
    want, want_g = _ref_loss_and_grads(ref_model, params, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want["loss"]),
                               rtol=1e-5)
    _close_grads(model.cfg, grads, want_g)
    model.cfg = dataclasses.replace(model.cfg, remat_policy="none")
    base, _, base_g = _port_grads(model, batch)
    torch.testing.assert_close(loss, base, rtol=1e-6, atol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, base_g[name], rtol=1e-6, atol=1e-6,
                                   msg=name)


def test_seq_shard_is_a_no_op_on_one_device():
    """``seq_shard=True`` gives the same loss and gradients as False, as
    the reference's constraint does outside a mesh."""
    _, _, model = _pair("qwen2.5-3b")
    batch = _batch(model.cfg)
    loss, _, grads = _port_grads(model, batch)
    grads = {n: g.clone() for n, g in grads.items()}
    model.cfg = dataclasses.replace(model.cfg, seq_shard=True)
    loss2, _, grads2 = _port_grads(model, batch)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)


# --- the train step ---------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=30)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(grad_dtype):
    """Three steps with microbatches=2 from one state: parameters, ``m``,
    ``v``, ``step``, ``loss``, ``grad_norm`` and ``lr`` against the
    reference's jitted step."""
    ref_model, params, model = _pair("qwen2.5-3b")
    ref_state = {"params": jax.tree.map(jnp.asarray, params),
                 "opt": ref_adamw.init_state(params)}
    ref_step = jax.jit(ref_make_train_step(ref_model, RefTrainConfig(
        microbatches=2, grad_dtype=grad_dtype, opt=RefOptConfig(**OPT))))
    state = load_train_state(model, train_state_from_reference(
        model.cfg, jax.tree.map(np.asarray, ref_state)))
    step = make_train_step(model, TrainConfig(
        microbatches=2, grad_dtype=grad_dtype, opt=OptConfig(**OPT)))
    for i in range(3):
        batch = _batch(model.cfg, b=4, seed=10 + i)
        ref_state, want = ref_step(ref_state, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
        state, got = step(state, batch)
        assert set(got) == set(want) == {"loss", "grad_norm", "lr"}
        for key in got:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
    want = train_state_from_reference(model.cfg,
                                      jax.tree.map(np.asarray, ref_state))
    assert int(state["opt"]["step"]) == int(want["opt"]["step"]) == 3
    rel, p_atol = (1e-4, 1e-5) if grad_dtype == "float32" else (
        2 ** -7, 3e-5)
    for name, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want["params"][name].numpy(), rtol=0,
                                   atol=p_atol, err_msg=name)
        for key, atol in (("m", 1e-6), ("v", 1e-9)):
            np.testing.assert_allclose(
                state["opt"][key][name].numpy(),
                want["opt"][key][name].numpy(), rtol=rel, atol=atol,
                err_msg=f"{key} {name}")


@pytest.mark.parametrize("name", NAMES)
def test_train_step_lowers_the_loss_on_a_fixed_batch(name):
    """The reference's ``test_smoke_train_step`` on the port: three steps
    with microbatches=2 on one batch, finite losses, the last below the
    first (each arch in its config's bf16 compute)."""
    model = Model(get_arch(name + "-smoke"), device="cpu")
    step = make_train_step(model, TrainConfig(microbatches=2))
    state = init_train_state(model)
    batch = _batch(model.cfg, b=4)
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_step_metrics_and_state_checks():
    """microbatches=1 adds ``ce``, ``aux`` and ``tokens``; a state that
    does not hold the model's parameters, and an unknown grad dtype, are
    refused."""
    model = Model(get_arch("qwen2.5-3b-smoke"), device="cpu")
    state = init_train_state(model)
    _, metrics = make_train_step(model, TrainConfig())(state,
                                                       _batch(model.cfg))
    assert set(metrics) == {"loss", "ce", "aux", "tokens", "grad_norm",
                            "lr"}
    assert float(metrics["tokens"]) == B * T
    other = Model(model.cfg, device="cpu")
    with pytest.raises(ValueError, match="not this model's"):
        make_train_step(other, TrainConfig())(state, _batch(model.cfg))
    with pytest.raises(ValueError, match="grad_dtype"):
        make_train_step(model, TrainConfig(grad_dtype="float16"))


# --- the loop -----------------------------------------------------------------

def _loop_setup(dtype="bfloat16"):
    cfg = dataclasses.replace(get_arch("qwen2.5-3b-smoke"),
                              dtype_compute=dtype)
    model = Model(cfg, device="cpu")
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2,
                                     decay_steps=30))
    return model, data, tcfg


def _quiet(_):
    pass


def test_crash_resume_equals_straight_run(tmp_path):
    model, data, tcfg = _loop_setup()
    h1 = train(model, data, tcfg, LoopConfig(
        total_steps=12, ckpt_every=6, log_every=100,
        ckpt_dir=str(tmp_path / "a")), log=_quiet)
    lcfg2 = LoopConfig(total_steps=12, ckpt_every=6, log_every=100,
                       ckpt_dir=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        train(model, data, tcfg, lcfg2, log=_quiet, fail_at_step=7)
    logs = []
    h2 = train(model, data, tcfg, lcfg2, log=logs.append)
    assert logs[0] == "[resume] restored checkpoint at step 6"
    assert len(h2["loss"]) == 6
    np.testing.assert_allclose(h1["loss"][-6:], h2["loss"], rtol=1e-5)


def test_train_puts_back_the_sigterm_handler(tmp_path):
    """``train`` installs its preemption guard for the run only: after a
    run that ends and after one that raises, SIGTERM's handler is the
    one that was there before."""
    import signal
    model, data, tcfg = _loop_setup()
    before = signal.getsignal(signal.SIGTERM)

    def lcfg(name):
        return LoopConfig(total_steps=2, ckpt_every=100, log_every=100,
                          ckpt_dir=str(tmp_path / name))

    train(model, data, tcfg, lcfg("ends"), log=_quiet)
    assert signal.getsignal(signal.SIGTERM) is before
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        train(model, data, tcfg, lcfg("raises"), log=_quiet, fail_at_step=1)
    assert signal.getsignal(signal.SIGTERM) is before


def test_loss_decreases(tmp_path):
    model, data, tcfg = _loop_setup()
    h = train(model, data, tcfg, LoopConfig(
        total_steps=25, ckpt_every=100, log_every=100,
        ckpt_dir=str(tmp_path / "c")), log=_quiet)
    assert np.mean(h["loss"][-5:]) < np.mean(h["loss"][:5])


def test_resume_from_the_reference_checkpoint(tmp_path):
    """The reference's loop trains 12 steps, writing a checkpoint at step
    6; the port restores that checkpoint (its manager reads the
    reference's ``||`` keys), converts it with
    ``convert.train_state_from_reference``, saves it as its own and
    resumes: steps 7-12 give the reference's losses (fp32 compute)."""
    model, data, tcfg = _loop_setup("float32")
    rcfg = dataclasses.replace(ref_get_arch("qwen2.5-3b-smoke"),
                               dtype_compute="float32")
    ref_model = RefModel(rcfg)
    ref_dir = str(tmp_path / "ref")
    want = ref_train(ref_model, RefDataConfig(**dataclasses.asdict(data)),
                     RefTrainConfig(opt=RefOptConfig(**OPT)),
                     RefLoopConfig(total_steps=12, ckpt_every=6,
                                   log_every=100, ckpt_dir=ref_dir),
                     log=_quiet)
    shapes = ref_model.param_shapes()
    like = {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                      "step": jax.ShapeDtypeStruct((),
                                                                   jnp.int32)}}
    step, host, _ = CheckpointManager(ref_dir).restore(like, step=6)
    assert step == 6
    state = train_state_from_reference(
        model.cfg, jax.tree.map(lambda t: t.numpy(), host))
    port_dir = str(tmp_path / "port")
    mgr = CheckpointManager(port_dir)
    mgr.save(6, state)
    mgr.wait()
    got = train(model, data, tcfg, LoopConfig(
        total_steps=12, ckpt_every=6, log_every=100, ckpt_dir=port_dir),
        log=_quiet)
    np.testing.assert_allclose(got["loss"], want["loss"][6:], rtol=1e-4)
