"""LM block families: the port's MoE, RG-LRU + local attention and RWKV-6
models against the reference's.

For recurrentgemma-2b, qwen3-moe-235b-a22b, phi3.5-moe-42b-a6.6b and
rwkv6-7b at ``-smoke`` size (this file), and llama-3.2-vision-90b and
whisper-tiny (``test_torch_multimodal.py``, which imports the helpers
here), in float32 and bfloat16 compute, the reference's
``Model.init(PRNGKey(0))`` parameters, with every leaf its init leaves
at zero or one redrawn from a seed (:func:`redraw`: QKV and layernorm
biases, norm scales, the MLP's ``bi``/``bo``, the cross ``gate``, the
RG-LRU ``conv_b``, RWKV's ``mu_*`` and ``u``; left at init they hide
whole paths, ``tanh(0) = 0`` and a zero token shift), go through
``convert.lm_params_from_reference`` into the port's ``Model`` on the
CPU (the attention runs ``plain.py``), and the same numpy-seeded tokens
(and image or audio embeds) go through both: the full forward's logits
and auxiliary loss, the prefill's logits and every cache plane (the
reference's stacked groups unstacked layer by layer), every decode
step's logits and caches, ``Model.loss`` and its gradients, and greedy
tokens in float32.

Tolerances (absolute and relative) are ``test_torch_lm``'s: logits 1e-4
in fp32 and 5e-2 in bf16; bf16 cache planes 2^-7 relative in fp32 and
2^-6 relative + 1e-2 absolute in bf16; the fp32 recurrent states (the
RG-LRU's ``h``, RWKV's ``s`` and token shifts) the logits' 1e-4 in fp32
and 5e-2 in bf16 (a token shift is the normed residual stream itself,
where one bf16 rounding the other way at magnitude 2-4, 2^-6 to 2^-5,
shows undamped: 0.0225 seen on the CPU); ``kpos`` exactly; the MoE's auxiliary
loss 1e-5 relative in fp32 and 1e-3 in bf16 (a mean of router
probabilities whose inputs differ by bf16 roundings: 2.1e-5 seen on
the CPU); the loss 1e-5 relative,
gradients 1e-4 relative + 1e-6 absolute (``test_torch_train``).  In
bf16 an MoE router whose K-th and (K+1)-th choice nearly tie may pick
the other expert in one package (the inputs differ by a bf16 rounding):
on the CPU that moved qwen3-moe's smoke logits by 0.043 at one position
of another seed's tokens, under the bound.

The reference's block tests (``tests/test_recurrent_blocks.py``) and
serving invariants (``tests/test_serve.py``, including the ring cache)
run on the port, each beside the reference's own output; an MoE layer
with a forced overload drops the same choices as the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import Model as RefModel
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import rwkv6 as ref_rwkv
from repro.models.kvcache import pad_caches as ref_pad_caches
from repro.models.specs import block_specs as ref_block_specs
from repro.models.specs import init_params as ref_init_params
from repro.models.transformer import forward as ref_forward
from repro.train.serve_step import greedy_generate as ref_greedy
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import (arch_config_from_reference,
                                 lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.models import Model
from repro_torch.models import moe, rglru, rwkv6
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import init_cache, pad_caches
from repro_torch.train.serve_step import greedy_generate
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          load_train_state, make_train_step)

FAMILIES = ["recurrentgemma-2b", "qwen3-moe-235b-a22b",
            "phi3.5-moe-42b-a6.6b", "rwkv6-7b"]
TOL = {"float32": dict(logits=1e-4, cache_rtol=2 ** -7, cache_atol=1e-4,
                       state=1e-4, aux=1e-5),
       "bfloat16": dict(logits=5e-2, cache_rtol=2 ** -6, cache_atol=1e-2,
                        state=5e-2, aux=1e-3)}
B, TT, T0 = 2, 12, 6          # prompt of T0 tokens, then TT - T0 decode steps
CHUNK = 8                     # loss_chunk of both models in the loss tests
# each leaf the reference's init leaves at zero or one, and its redraw:
# (base, scale) for base + normal(0, scale), or "unit" for uniform [0, 1)
REDRAW = {"bq": (0, 0.5), "bk": (0, 0.5), "bv": (0, 0.5),
          "scale": (1, 0.1), "gn_scale": (1, 0.1), "bias": (0, 0.1),
          "bi": (0, 0.1), "bo": (0, 0.1), "conv_b": (0, 0.1),
          "gate": (0, 0.5), "u": (0, 0.5), "mu_r": "unit", "mu_k": "unit",
          "mu_v": "unit", "mu_g": "unit", "mu_w": "unit", "c_mu_k": "unit",
          "c_mu_r": "unit"}


def redraw(tree, rng):
    """The reference's params with every zero- or one-initialised leaf
    drawn from ``rng`` (``REDRAW``); every other leaf as it was."""
    out = {}
    for key, x in tree.items():
        if isinstance(x, dict):
            out[key] = redraw(x, rng)
        elif key in REDRAW:
            how = REDRAW[key]
            draw = rng.random(x.shape) if how == "unit" else \
                how[0] + rng.normal(0, how[1], x.shape)
            out[key] = draw.astype(x.dtype)
        else:
            assert not (np.all(x == 0) or np.all(x == 1)), key
            out[key] = x
    return out


def ref_cfg(name, dtype, **fields):
    return dataclasses.replace(ref_get_arch(name + "-smoke"),
                               dtype_compute=dtype, **fields)


@functools.lru_cache(maxsize=None)
def pair(name, dtype, fields=()):
    """(reference cfg, reference params as numpy, port model on the CPU),
    the params redrawn (:func:`redraw`, seeded).  ``fields``: (name,
    value) pairs replaced in both configs."""
    rcfg = ref_cfg(name, dtype, **dict(fields))
    cfg = arch_config_from_reference(dataclasses.asdict(rcfg))
    assert cfg == dataclasses.replace(get_arch(name + "-smoke"),
                                      dtype_compute=dtype, **dict(fields))
    params = redraw(jax.tree.map(np.asarray, RefModel(rcfg).init(
        jax.random.PRNGKey(0))), np.random.default_rng(5))
    model = Model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, params))
    return rcfg, params, model


def make_batch(cfg, t=TT, b=B, seed=1):
    """Tokens and targets from ``data/tokens.py``, and the family's image
    or audio embeds, normal(0, 1) from a numpy seed."""
    out = batch_at(DataConfig(vocab=cfg.vocab, seq_len=t, global_batch=b,
                              seed=seed), 0)
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "audio":
        out["audio_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out


def inputs(batch, t=None):
    """The batch without targets, tokens cut to ``t``."""
    out = {k: v for k, v in batch.items() if k != "targets"}
    if t is not None:
        out["tokens"] = out["tokens"][:, :t]
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_run(name, dtype):
    """The reference's full forward (logits, aux), prefill (logits,
    caches) and every decode step (logits, caches) on the smoke batch,
    jitted, as numpy."""
    rcfg, params, model = pair(name, dtype)
    ref_model = RefModel(rcfg)
    batch = make_batch(model.cfg)
    jp = jax.tree.map(jnp.asarray, params)
    logits, aux = jax.jit(functools.partial(ref_forward, rcfg))(
        jp, jax_batch(inputs(batch)))
    lg, caches = jax.jit(ref_model.prefill)(jp, jax_batch(inputs(batch, T0)))
    out = {"forward": (np.asarray(logits), float(aux)),
           "prefill": (np.asarray(lg), jax.tree.map(np.asarray, caches))}
    caches = ref_pad_caches(rcfg, caches, TT - T0)
    decode = jax.jit(ref_model.decode)
    steps = []
    for i in range(T0, TT):
        lg, caches = decode(jp, caches, jnp.asarray(batch["tokens"][:, i:i + 1]),
                            jnp.asarray(i, jnp.int32))
        steps.append((np.asarray(lg), jax.tree.map(np.asarray, caches)))
    out["decode"] = steps
    return out


def close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                               np.float32), rtol=tol, atol=tol, err_msg=what)


def unstack(cfg, caches):
    """The reference's cache tree as the port's list: layer
    ``g·len(pattern) + j`` is entry ``g`` of ``groups["b<j>_<kind>"]``,
    the remainder layers ``rem["r<j>_<kind>"]``."""
    pat = cfg.pattern
    out = []
    for g in range(cfg.n_groups):
        for j, kind in enumerate(pat):
            out.append({k: v[g] for k, v in
                        caches["groups"][f"b{j}_{kind}"].items()})
    for j, kind in enumerate(pat[: cfg.n_rem_layers]):
        out.append(caches["rem"][f"r{j}_{kind}"])
    return out


def close_caches(cfg, got, want_tree, tol, what):
    want = unstack(cfg, want_tree)
    assert len(got) == len(want) == cfg.n_layers
    for i, (c, w) in enumerate(zip(got, want)):
        assert set(c) == set(w), (i, set(c), set(w))
        for key, ref in w.items():
            g = c[key]
            msg = f"{what} layer {i} ({cfg.layer_kinds()[i]}) {key}"
            assert tuple(g.shape) == ref.shape, msg
            if key == "kpos":
                np.testing.assert_array_equal(g.numpy(), ref, err_msg=msg)
                continue
            if g.dtype == torch.float32:
                rtol = atol = tol["state"]
            else:
                assert g.dtype == torch.bfloat16, msg
                rtol, atol = tol["cache_rtol"], tol["cache_atol"]
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(ref, np.float32),
                                       rtol=rtol, atol=atol, err_msg=msg)


def check_forward(name, dtype):
    _, _, model = pair(name, dtype)
    want, want_aux = reference_run(name, dtype)["forward"]
    with torch.no_grad():
        logits, aux = T.forward(model.cfg, model, model._inputs(
            make_batch(model.cfg)))
    close(logits, want, TOL[dtype]["logits"], "forward")
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), want_aux, rtol=TOL[dtype]["aux"],
                               atol=1e-7)
    if model.cfg.n_experts:
        assert want_aux > 0


def check_prefill(name, dtype):
    _, _, model = pair(name, dtype)
    want_lg, want_c = reference_run(name, dtype)["prefill"]
    lg, caches = model.prefill(inputs(make_batch(model.cfg), T0))
    close(lg, want_lg, TOL[dtype]["logits"], "prefill logits")
    close_caches(model.cfg, caches, want_c, TOL[dtype], "prefill cache")


def check_decode(name, dtype):
    _, _, model = pair(name, dtype)
    batch = make_batch(model.cfg)
    _, caches = model.prefill(inputs(batch, T0))
    caches = pad_caches(model.cfg, caches, TT - T0)
    for i, (want_lg, want_c) in zip(range(T0, TT),
                                    reference_run(name, dtype)["decode"]):
        lg, caches = model.decode(caches, batch["tokens"][:, i:i + 1], i)
        close(lg, want_lg, TOL[dtype]["logits"], f"decode logits pos {i}")
        close_caches(model.cfg, caches, want_c, TOL[dtype],
                     f"decode cache pos {i}")


def check_loss_and_grads(name):
    """``Model.loss`` (ce + the router's aux) and every parameter's
    gradient against the reference's ``jax.value_and_grad`` of its loss,
    fp32, two loss chunks."""
    rcfg, params, _ = pair(name, "float32")
    cfg = arch_config_from_reference(dataclasses.asdict(rcfg))
    model = Model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, params))
    model.loss_chunk = CHUNK
    batch = make_batch(cfg, t=16)
    fn = jax.jit(jax.value_and_grad(RefModel(rcfg, loss_chunk=CHUNK).loss,
                                    has_aux=True))
    (_, want), want_g = fn(jax.tree.map(jnp.asarray, params),
                           jax_batch(batch))
    loss, metrics = model.loss(batch)
    loss.backward()
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-8, err_msg=key)
    assert (float(metrics["aux"]) > 0) == bool(cfg.n_experts)
    want_g = lm_params_from_reference(cfg, jax.tree.map(np.asarray, want_g))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want_g)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def check_greedy(name):
    rcfg, params, model = pair(name, "float32")
    batch = inputs(make_batch(model.cfg, seed=2))
    want = ref_greedy(RefModel(rcfg), params, jax_batch(batch), steps=5)
    got = greedy_generate(model, batch, steps=5)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_prefill_decode_matches_forward(name):
    """The reference's ``test_prefill_decode_matches_forward`` on the port
    alone, with its config (fp32, ``capacity_factor`` 8.0: nothing drops
    at smoke size) and tolerances: 2e-3 for the prefill, 5e-3 a decode
    step (the bf16 caches)."""
    cfg = dataclasses.replace(get_arch(name + "-smoke"),
                              dtype_compute="float32", capacity_factor=8.0)
    model = Model(cfg, device="cpu")
    batch = inputs(make_batch(cfg, seed=3))
    full = model(batch)
    lg, caches = model.prefill(inputs(batch, T0))
    torch.testing.assert_close(lg, full[:, T0 - 1], rtol=2e-3, atol=2e-3)
    caches = pad_caches(cfg, caches, TT - T0)
    for i in range(T0, TT):
        lg, caches = model.decode(caches, batch["tokens"][:, i:i + 1], i)
        torch.testing.assert_close(lg, full[:, i], rtol=5e-3, atol=5e-3,
                                   msg=f"{name} pos {i}")


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(name, dtype):
    check_forward(name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(name, dtype):
    check_prefill(name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_reference(name, dtype):
    check_decode(name, dtype)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_tokens_equal_reference_fp32(name):
    check_greedy(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_decode_matches_forward(name):
    check_prefill_decode_matches_forward(name)


# --- the ring cache -----------------------------------------------------------

@pytest.mark.parametrize("prompt", [4, 8, 13])
def test_sliding_window_cache_is_ring(prompt):
    """The reference's ``test_sliding_window_cache_is_ring`` on the port
    (window 8, 24 tokens), with prompts shorter than, equal to and longer
    than the window: decoding past the window evicts only out-of-window
    positions, so every step equals the full forward."""
    cfg = dataclasses.replace(get_arch("recurrentgemma-2b-smoke"),
                              dtype_compute="float32", window=8)
    model = Model(cfg, device="cpu")
    toks = make_batch(cfg, t=24, b=1, seed=4)["tokens"]
    full = model({"tokens": toks})
    lg, caches = model.prefill({"tokens": toks[:, :prompt]})
    torch.testing.assert_close(lg, full[:, prompt - 1], rtol=2e-3, atol=2e-3)
    ring = caches[2]
    assert cfg.layer_kinds()[2] == "local" and ring["k"].shape[1] == 8
    want = [max(p, -1) for p in ((prompt - 1) - ((prompt - 1 - i) % 8)
                                 for i in range(8))]
    assert ring["kpos"].tolist() == [p if p >= 0 else -1 for p in want]
    caches = pad_caches(cfg, caches, 24 - prompt)
    assert caches[2]["k"].shape[1] == 8          # rings are not padded
    for i in range(prompt, 24):
        lg, caches = model.decode(caches, toks[:, i:i + 1], i)
        torch.testing.assert_close(lg, full[:, i], rtol=5e-3, atol=5e-3,
                                   msg=f"pos {i}")
        assert caches[2]["kpos"][i % 8] == i


@pytest.mark.parametrize("window", [4, 6, 16])
def test_ring_cache_matches_reference(window):
    """Prefill of 6 tokens into a ring of ``window`` slots (longer than,
    equal to, shorter than the prompt) and six decode steps that wrap it:
    logits and every cache plane (``kpos`` exactly) equal the
    reference's, fp32."""
    rcfg, params, model = pair("recurrentgemma-2b", "float32",
                               (("window", window),))
    ref_model = RefModel(rcfg)
    toks = make_batch(model.cfg)["tokens"]
    jp = jax.tree.map(jnp.asarray, params)
    want_lg, want_c = ref_model.prefill(jp, {"tokens": jnp.asarray(
        toks[:, :T0])})
    lg, caches = model.prefill({"tokens": toks[:, :T0]})
    tol = TOL["float32"]
    close(lg, want_lg, tol["logits"], "prefill")
    close_caches(model.cfg, caches, jax.tree.map(np.asarray, want_c), tol,
                 "prefill")
    want_c = ref_pad_caches(rcfg, want_c, TT - T0)
    caches = pad_caches(model.cfg, caches, TT - T0)
    decode = jax.jit(ref_model.decode)
    for i in range(T0, TT):
        want_lg, want_c = decode(jp, want_c, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.asarray(i, jnp.int32))
        lg, caches = model.decode(caches, toks[:, i:i + 1], i)
        close(lg, want_lg, tol["logits"], f"decode {i}")
        close_caches(model.cfg, caches, jax.tree.map(np.asarray, want_c),
                     tol, f"decode {i}")


# --- the reference's block tests (tests/test_recurrent_blocks.py) ----------

def _block_cfg(**kw):
    base = dict(name="t", family="ssm", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=64, vocab=64, rwkv_head_dim=8,
                d_rnn=32, block_pattern=("rwkv",), dtype_compute="float32")
    base.update(kw)
    return RefArchConfig(**base), ArchConfig(**base)


def _block_params(rcfg, kind, part):
    """The reference's init of one block, redrawn, as numpy and as
    torch."""
    p = redraw(jax.tree.map(np.asarray, ref_init_params(
        ref_block_specs(rcfg, kind), jax.random.PRNGKey(0))),
        np.random.default_rng(6))[part]
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def test_rwkv_chunked_equals_stepwise():
    """The chunked time mix over 70 tokens (three chunks, the last
    padded) equals 70 one-token steps (3e-4, the reference's bound), and
    both equal the reference's chunked output and state (1e-5)."""
    rcfg, cfg = _block_cfg()
    rp, p = _block_params(rcfg, "rwkv", "mix")
    x = np.random.default_rng(1).standard_normal((2, 70, 32)).astype(
        np.float32) * 0.5
    want, want_s, _ = ref_rwkv.rwkv_time_mix(rcfg, rp, jnp.asarray(x))
    xt = torch.from_numpy(x)
    out, s_fin, shift = rwkv6.rwkv_time_mix(cfg, p, xt)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    st, sh, outs = torch.zeros((2, 4, 8, 8)), torch.zeros((2, 32)), []
    for t in range(70):
        o, st, sh = rwkv6.rwkv_time_mix_step(cfg, p, xt[:, t:t + 1],
                                             state=st, shift_prev=sh)
        outs.append(o[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), out, rtol=3e-4,
                               atol=3e-4)
    torch.testing.assert_close(st, s_fin, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(shift, xt[:, -1])


def test_rglru_scan_equals_stepwise():
    """The log-depth scan over 33 steps equals 33 recurrence steps (1e-5,
    the reference's bound) and the reference's associative scan."""
    rcfg, cfg = _block_cfg(block_pattern=("rglru",))
    rp, p = _block_params(rcfg, "rglru", "rec")
    xc = np.random.default_rng(2).standard_normal((2, 33, 32)).astype(
        np.float32) * 0.5
    h0 = np.random.default_rng(3).standard_normal((2, 32)).astype(
        np.float32)
    for init in (None, h0):
        want, want_last = ref_rglru.rglru_scan(
            rcfg, rp, jnp.asarray(xc), None if init is None
            else jnp.asarray(init))
        h_init = None if init is None else torch.from_numpy(init)
        h_seq, h_last = rglru.rglru_scan(cfg, p, torch.from_numpy(xc), h_init)
        np.testing.assert_allclose(h_seq.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                                   rtol=1e-5, atol=1e-5)
        h = torch.zeros((2, 32)) if init is None else h_init
        outs = []
        for t in range(33):
            step_h, h = rglru.rglru_step(cfg, p, torch.from_numpy(
                xc[:, t:t + 1]), h)
            outs.append(step_h[:, 0])
        torch.testing.assert_close(torch.stack(outs, 1), h_seq, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(h, h_last, rtol=1e-5, atol=1e-5)


def test_rglru_block_prefill_then_step():
    """A 6-token prefill with a cache, then one-token steps, equal the
    cache-free block over 12 tokens (2e-2: the conv tail is bf16), and
    every output and cache equals the reference's (1e-5)."""
    rcfg, cfg = _block_cfg(block_pattern=("rglru",))
    rp, p = _block_params(rcfg, "rglru", "rec")
    x = np.random.default_rng(3).standard_normal((1, 12, 32)).astype(
        np.float32) * 0.5
    xt = torch.from_numpy(x)
    full, none = rglru.rglru_block(cfg, p, xt)
    assert none is None
    want_full, _ = ref_rglru.rglru_block(rcfg, rp, jnp.asarray(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(want_full),
                               rtol=1e-5, atol=1e-5)
    cache = {"h": torch.zeros((1, 32)),
             "conv": torch.zeros((1, cfg.conv_width - 1, 32),
                                 dtype=torch.bfloat16)}
    ref_cache = {"h": jnp.zeros((1, 32)),
                 "conv": jnp.zeros((1, cfg.conv_width - 1, 32),
                                   jnp.bfloat16)}
    for lo, hi in [(0, 6)] + [(t, t + 1) for t in range(6, 12)]:
        o, cache = rglru.rglru_block(cfg, p, xt[:, lo:hi], cache=cache)
        w, ref_cache = ref_rglru.rglru_block(rcfg, rp,
                                             jnp.asarray(x[:, lo:hi]),
                                             cache=ref_cache)
        torch.testing.assert_close(o, full[:, lo:hi], rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=str(lo))
        assert cache["conv"].dtype == torch.bfloat16
        for key in ("h", "conv"):
            np.testing.assert_allclose(
                cache[key].float().numpy(),
                np.asarray(ref_cache[key], np.float32), rtol=1e-5,
                atol=1e-5, err_msg=f"{lo} {key}")


def test_rwkv_state_decay_bounded():
    """Inputs of scale 50: the clipped decay keeps the chunk's
    exponentials finite, and the output equals the reference's."""
    rcfg, cfg = _block_cfg()
    rp, p = _block_params(rcfg, "rwkv", "mix")
    x = np.random.default_rng(4).standard_normal((1, 64, 32)).astype(
        np.float32) * 50.0
    out, s, _ = rwkv6.rwkv_time_mix(cfg, p, torch.from_numpy(x))
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s).all())
    want, want_s, _ = ref_rwkv.rwkv_time_mix(rcfg, rp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-3)


# --- MoE routing --------------------------------------------------------------

def _drops(expert_ids, cap):
    """Per row, the (token, choice) pairs ranked at or past ``cap`` in
    their expert, in a stable order of the T·K choices: the reference's
    rule, in numpy."""
    b, t, k = expert_ids.shape
    flat = expert_ids.reshape(b, t * k)
    dropped = np.zeros((b, t * k), bool)
    for r in range(b):
        seen = {}
        for i, e in enumerate(flat[r]):
            dropped[r, i] = seen.get(e, 0) >= cap
            seen[e] = seen.get(e, 0) + 1
    return dropped.reshape(b, t, k)


@pytest.mark.parametrize("tokens", [24, 1])
def test_moe_overload_drops_as_reference(tokens):
    """A router that sends most tokens to expert 0 with capacity factor
    0.5: the port drops the same choices as the reference (the output of
    a token with every choice dropped is exactly zero in both), its
    output and aux loss equal the reference's (fp32, 1e-5); a one-token
    step (decode) drops nothing."""
    rcfg = ref_cfg("qwen3-moe-235b-a22b", "float32", capacity_factor=0.5)
    cfg = arch_config_from_reference(dataclasses.asdict(rcfg))
    rng = np.random.default_rng(7)
    D, E = cfg.d_model, cfg.n_experts
    p = {"router": rng.normal(0, 0.1, (D, E)).astype(np.float32),
         "wi": rng.normal(0, 0.1, (E, D, cfg.d_ff)).astype(np.float32),
         "wg": rng.normal(0, 0.1, (E, D, cfg.d_ff)).astype(np.float32),
         "wo": rng.normal(0, 0.1, (E, cfg.d_ff, D)).astype(np.float32)}
    p["router"][:, 0] += 0.3                     # expert 0 is everyone's
    x = rng.standard_normal((2, tokens, D)).astype(np.float32)
    x[..., :] += 1.0
    want, want_aux = ref_moe.moe_ffn(rcfg, {k: jnp.asarray(v) for k, v in
                                           p.items()}, jnp.asarray(x))
    got, aux = moe.moe_ffn(cfg, {k: torch.from_numpy(v) for k, v in
                                 p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, ids = jax.lax.top_k(probs, cfg.top_k)
    cap = tokens * cfg.top_k if tokens == 1 else max(
        1, int(tokens * cfg.top_k * cfg.capacity_factor / E))
    dropped = _drops(np.asarray(ids), cap)
    if tokens == 1:
        assert not dropped.any()
        return
    assert dropped.sum() > tokens // 2             # the overload drops
    all_dropped = dropped.all(-1)
    assert all_dropped.any()
    assert not got[torch.from_numpy(all_dropped)].any()
    assert not np.asarray(want)[all_dropped].any()
    assert got[torch.from_numpy(~all_dropped)].abs().amax(-1).min() > 0


# --- configs, parameters, the train state ------------------------------------

def test_get_arch_resolves_all_ten():
    assert set(ARCHS) == set(REF_ARCHS) and len(ARCHS) == 10
    for name in ARCHS:
        for n in (name, name + "-smoke"):
            got, want = get_arch(n), ref_get_arch(n)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), n
            got.check_ported()


def test_full_config_param_counts_match_names():
    """The reference's ``test_full_config_param_counts_match_names``: the
    parameter count lands near the advertised size."""
    expect = {"minitron-8b": (8, 11), "stablelm-12b": (11, 13),
              "qwen2.5-3b": (2.5, 3.5), "yi-6b": (5.5, 6.5),
              "qwen3-moe-235b-a22b": (230, 240),
              "phi3.5-moe-42b-a6.6b": (40, 44),
              "llama-3.2-vision-90b": (80, 95),
              "rwkv6-7b": (7, 9), "whisper-tiny": (0.03, 0.08),
              "recurrentgemma-2b": (2, 4)}
    for name, (lo, hi) in expect.items():
        n = ARCHS[name].param_count() / 1e9
        assert lo <= n <= hi, (name, n)


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_active_params_match_reference(name):
    """Active parameters equal the reference's (the reference's
    ``test_moe_active_params``: qwen3-moe's lies in [20, 25] billion)."""
    got = ARCHS[name].active_param_count()
    assert got == REF_ARCHS[name].active_param_count()
    if ARCHS[name].n_experts:
        assert got < ARCHS[name].param_count()
    else:
        assert got == ARCHS[name].param_count()
    if name == "qwen3-moe-235b-a22b":
        assert 20 <= got / 1e9 <= 25


@pytest.mark.parametrize("name", FAMILIES + ["llama-3.2-vision-90b",
                                             "whisper-tiny"])
def test_train_state_from_reference_carries_every_leaf(name):
    """A reference train state (params, AdamW's m and v as distinct
    draws, step) carries into the port's model and optimizer: every
    state-dict name, shape and value, with the groups and remainder
    layers unstacked, ``img_proj`` and the encoder's blocks; one port
    step runs from it."""
    rcfg, params, _ = pair(name, "float32")
    cfg = arch_config_from_reference(dataclasses.asdict(rcfg))
    rng = np.random.default_rng(8)
    m = jax.tree.map(lambda a: rng.normal(0, 1e-3, a.shape).astype(
        np.float32), params)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32) * 1e-6,
                     params)
    state = train_state_from_reference(
        cfg, {"params": params, "opt": {"m": m, "v": v,
                                        "step": np.int32(3)}})
    model = Model(cfg, device="cpu")
    st = load_train_state(model, state)
    sd = model.state_dict()
    assert set(st["opt"]["m"]) == set(sd) == set(state["params"])
    for n, t in sd.items():
        torch.testing.assert_close(t, state["params"][n], rtol=0, atol=0)
        assert st["opt"]["m"][n].shape == t.shape
    step = make_train_step(model, TrainConfig())
    st, metrics = step(st, make_batch(cfg, t=16))
    assert int(st["opt"]["step"]) == 4 and np.isfinite(float(
        metrics["loss"]))


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "recurrentgemma-2b",
                                  "rwkv6-7b"])
def test_train_step_lowers_the_loss(name):
    """The reference's ``test_smoke_train_step`` on the port: three steps
    in two microbatches on a fixed batch lower the loss."""
    model = Model(get_arch(name + "-smoke"), device="cpu")
    step = make_train_step(model, TrainConfig(microbatches=2))
    state = init_train_state(model)
    batch = make_batch(model.cfg, t=16, b=4)
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_rem_layers_follow_the_groups():
    """A pattern that leaves remainder layers (5 layers of (rglru, rglru,
    local): one group, then two rglru): the port's blocks are the
    reference's layers in order, and the logits agree (fp32)."""
    rcfg, params, model = pair("recurrentgemma-2b", "float32",
                               (("n_layers", 5),))
    cfg = model.cfg
    assert cfg.layer_kinds() == ("rglru", "rglru", "local", "rglru", "rglru")
    assert "rem" in params and set(params["rem"]) == {"r0_rglru",
                                                      "r1_rglru"}
    np.testing.assert_array_equal(
        model.blocks[4]["rec"]["wx"].detach().numpy(),
        params["rem"]["r1_rglru"]["rec"]["wx"])
    toks = make_batch(cfg)["tokens"]
    want, _ = ref_forward(rcfg, params, {"tokens": jnp.asarray(toks)})
    close(model({"tokens": toks}), want, 1e-4, "forward")
    want_lg, want_c = RefModel(rcfg).prefill(params, {"tokens": jnp.asarray(
        toks[:, :T0])})
    lg, caches = model.prefill({"tokens": toks[:, :T0]})
    close(lg, want_lg, 1e-4, "prefill")
    close_caches(cfg, caches, jax.tree.map(np.asarray, want_c),
                 TOL["float32"], "prefill")


def test_init_cache_shapes_match_reference():
    """``init_cache`` of every family: per layer the reference's
    ``block_cache_shapes`` (shape and dtype), ``kpos`` -1."""
    from repro.models.kvcache import init_cache as ref_init_cache
    for name in FAMILIES + ["llama-3.2-vision-90b", "whisper-tiny"]:
        cfg = get_arch(name + "-smoke")
        got = init_cache(cfg, 2, 10, torch.device("cpu"))
        want = unstack(cfg, jax.tree.map(np.asarray, ref_init_cache(
            ref_get_arch(name + "-smoke"), 2, 10)))
        for c, w in zip(got, want):
            assert set(c) == set(w)
            for k in c:
                assert tuple(c[k].shape) == w[k].shape, (name, k)
                assert str(c[k].dtype)[6:] == str(w[k].dtype), (name, k)
                np.testing.assert_array_equal(c[k].float().numpy(),
                                              w[k].astype(np.float32))
