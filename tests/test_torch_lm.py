"""LM serving: the port's dense model against the reference's.

For each dense architecture at ``-smoke`` size, in float32 and bfloat16
compute, the reference's ``Model.init(PRNGKey(0))`` parameters go through
``convert.lm_params_from_reference`` into the port's ``Model`` (on the
CPU, so the attention runs ``plain.py``), and the same numpy-seeded
tokens go through both: the full forward's logits, the prefill's logits
and caches, and every decode step's logits and caches must agree.

Tolerances (absolute and relative), per compute dtype:

  * float32: 1e-4 on logits and caches.  Both compute the same einsums
    in fp32, in other summation orders (2.4e-7 seen on the CPU, against
    logits up to 1.3); the caches are bf16 in both packages, and an fp32
    difference that crosses a bf16 rounding boundary moves a value by
    one bf16 step, 2^-8 relative, so the caches get 2^-7 relative.
  * bfloat16: 5e-2 on logits, 2^-6 relative and 1e-2 absolute on
    caches.  Both round every product and the attention output to bf16,
    where one rounding the other way is 2^-8 relative, and such steps
    compound over two layers to the logits (2.6e-3 seen on the CPU).

The reference's init leaves the QKV biases at zero and the norm scales at
one, so ``_pair`` redraws them (seeded) before both packages run: the
bias is then added in the compute dtype after the product, and the norm
multiplies by its fp32 scale before rounding back, in both or the logits
part.  At those tolerances a rounding point moved (the bias added in
fp32, the scale applied after rounding) still passes, so
``test_bf16_rounding_points_match_reference`` holds the norm and the QKV
projection to the reference's element for element: they agree bit for bit
on the CPU, where either move changes 25-37% of the elements by a bf16
step.

Greedy tokens must equal the reference's in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.models.kvcache import pad_caches as ref_pad_caches
from repro.models.transformer import forward as ref_forward
from repro.train.serve_step import greedy_generate as ref_greedy
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import (arch_config_from_reference,
                                 lm_params_from_reference)
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.models.kvcache import pad_caches
from repro_torch.train.serve_step import (greedy_generate, make_decode_step,
                                          make_prefill_step)

NAMES = ["qwen2.5-3b", "minitron-8b", "yi-6b", "stablelm-12b"]
TOL = {"float32": dict(logits=1e-4, cache_rtol=2 ** -7, cache_atol=1e-4),
       "bfloat16": dict(logits=5e-2, cache_rtol=2 ** -6, cache_atol=1e-2)}
B, T, T0 = 2, 12, 6          # prompt of T0 tokens, then T - T0 decode steps


def _redraw(tree, rng):
    """The reference's params with every QKV bias drawn from normal(0,
    0.5) and every norm scale from 1 + normal(0, 0.1)."""
    out = {}
    for key, x in tree.items():
        if isinstance(x, dict):
            out[key] = _redraw(x, rng)
        elif key in ("bq", "bk", "bv"):
            out[key] = rng.normal(0, 0.5, x.shape).astype(x.dtype)
        elif key == "scale":
            out[key] = (1 + rng.normal(0, 0.1, x.shape)).astype(x.dtype)
        else:
            out[key] = x
    return out


def _pair(name, dtype):
    """(reference cfg, reference params as numpy, port model on the CPU):
    the reference's ``Model.init(PRNGKey(0))`` with biases and norm
    scales redrawn (``_redraw``, seeded)."""
    rcfg = dataclasses.replace(ref_get_arch(name + "-smoke"),
                               dtype_compute=dtype)
    cfg = arch_config_from_reference(dataclasses.asdict(rcfg))
    assert cfg == dataclasses.replace(get_arch(name + "-smoke"),
                                      dtype_compute=dtype)
    params = _redraw(jax.tree.map(np.asarray, RefModel(rcfg).init(
        jax.random.PRNGKey(0))), np.random.default_rng(5))
    model = Model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, params))
    return rcfg, params, model


def _tokens(cfg, seed=1):
    return batch_at(DataConfig(vocab=cfg.vocab, seq_len=T, global_batch=B,
                               seed=seed), 0)["tokens"]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                               np.float32), rtol=tol, atol=tol, err_msg=what)


def _close_caches(got, want, tol, what):
    for i, c in enumerate(got):
        for key in ("k", "v"):
            ref = np.asarray(want["groups"]["b0_attn"][key][i], np.float32)
            np.testing.assert_allclose(
                c[key].float().numpy(), ref, rtol=tol["cache_rtol"],
                atol=tol["cache_atol"], err_msg=f"{what} layer {i} {key}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_decode_match_reference(name, dtype):
    rcfg, params, model = _pair(name, dtype)
    tol = TOL[dtype]
    toks = _tokens(model.cfg)
    want_full, _ = ref_forward(rcfg, params, {"tokens": jnp.asarray(toks)})
    _close(model({"tokens": toks}), want_full, tol["logits"], "forward")

    ref_model = RefModel(rcfg)
    want_lg, want_c = ref_model.prefill(params,
                                        {"tokens": jnp.asarray(toks[:, :T0])})
    lg, caches = make_prefill_step(model)({"tokens": toks[:, :T0]})
    _close(lg, want_lg, tol["logits"], "prefill logits")
    _close_caches(caches, want_c, tol, "prefill cache")

    want_c = ref_pad_caches(rcfg, want_c, T - T0)
    caches = pad_caches(model.cfg, caches, T - T0)
    decode = make_decode_step(model)
    for i in range(T0, T):
        want_lg, want_c = ref_model.decode(
            params, want_c, jnp.asarray(toks[:, i:i + 1]),
            jnp.asarray(i, jnp.int32))
        lg, caches = decode(caches, toks[:, i:i + 1], i)
        _close(lg, want_lg, tol["logits"], f"decode logits pos {i}")
        _close_caches(caches, want_c, tol, f"decode cache pos {i}")


@pytest.mark.parametrize("name", NAMES)
def test_bf16_rounding_points_match_reference(name):
    """The first layer's norm and QKV projection in bf16 on one input:
    at most 1% of the elements may differ from the reference's (one
    rounding the other way after a product summed in another order)."""
    rcfg, params, model = _pair(name, "bfloat16")
    group = params["groups"]["b0_attn"]
    ref_p = {part: {k: v[0] for k, v in group[part].items()}
             for part in ("ln1", "attn")}
    blk = model.blocks[0]
    x = np.random.default_rng(7).normal(0, 1, (B, T, rcfg.d_model))
    x = jnp.asarray(x, jnp.bfloat16)

    def same(want, got, what):
        want = np.asarray(want.astype(jnp.float32))
        frac = float(np.mean(want != got.float().numpy()))
        assert frac <= 0.01, f"{name} {what}: {frac:.3f} of elements differ"

    h_want = ref_layers.norm(rcfg, ref_p["ln1"], x)
    def bf16(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    h = bf16(h_want)
    with torch.no_grad():
        same(h_want, layers.norm(model.cfg, blk["ln1"], bf16(x)), "norm")
        for what, want, got in zip(
                "qkv", ref_layers._proj_qkv(rcfg, ref_p["attn"], h_want),
                layers._proj_qkv(model.cfg, blk["attn"], h)):
            same(want, got, what)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_equal_reference_fp32(name):
    rcfg, params, model = _pair(name, "float32")
    toks = _tokens(model.cfg, seed=2)
    want = ref_greedy(RefModel(rcfg), params, {"tokens": jnp.asarray(toks)},
                      steps=5)
    got = greedy_generate(model, {"tokens": toks}, steps=5)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_matches_forward(name):
    """The reference's serving invariant (``tests/test_serve.py``) on the
    port alone, with its tolerances: the caches are bf16, so decode
    differs from the full forward by 2e-3 (prefill) and 5e-3 (decode)."""
    cfg = dataclasses.replace(get_arch(name + "-smoke"),
                              dtype_compute="float32")
    model = Model(cfg, device="cpu")
    toks = _tokens(cfg, seed=3)
    full = model({"tokens": toks})
    lg, caches = model.prefill({"tokens": toks[:, :T0]})
    torch.testing.assert_close(lg, full[:, T0 - 1], rtol=2e-3, atol=2e-3)
    caches = pad_caches(cfg, caches, T - T0)
    for i in range(T0, T):
        lg, caches = model.decode(caches, toks[:, i:i + 1], i)
        torch.testing.assert_close(lg, full[:, i], rtol=5e-3, atol=5e-3,
                                   msg=f"{name} pos {i}")


@pytest.mark.parametrize("impl,ref_impl", [("fused", "pallas"),
                                           ("chain", "xla"), ("ref", "ref")])
def test_attention_impls_match_reference(impl, ref_impl):
    """Each port attention path in the model against the reference's
    counterpart (the Pallas kernel in interpret mode), float32."""
    rcfg, params, model = _pair("qwen2.5-3b", "float32")
    model.impl = impl
    toks = _tokens(model.cfg, seed=4)
    want, _ = ref_forward(rcfg, params, {"tokens": jnp.asarray(toks)},
                          impl=ref_impl)
    _close(model({"tokens": toks}), want, TOL["float32"]["logits"], impl)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_full_config_param_counts_match_reference(name):
    want = ref_get_arch(name).param_count()
    assert get_arch(name).param_count() == want
    if name == "qwen2.5-3b":
        assert want == 3_085_938_688
    small = Model(get_arch(name + "-smoke"), device="cpu")
    assert small.param_count() == ref_get_arch(name + "-smoke").param_count()


@pytest.mark.parametrize("field,value", [("cost_exact", True)])
def test_model_refuses_fields_it_does_not_honour(field, value, monkeypatch):
    """A config with a field listed in ``configs/base.py::WAITING`` (one
    the port's model does not read) raises at construction, naming the
    field and its ROADMAP item; the ten configs and their smoke twins
    pass.  ``cost_exact`` was the last such field: honoured now (the
    cost probe's one-chunk loss), a config that sets it builds, and
    listed in ``WAITING`` again it is refused."""
    from repro_torch.configs import base
    for name in ARCHS:
        get_arch(name).check_ported()
        get_arch(name + "-smoke").check_ported()
    assert base.WAITING == {}
    cfg = dataclasses.replace(get_arch("qwen2.5-3b-smoke"), **{field: value})
    Model(cfg, device="cpu")
    monkeypatch.setitem(base.WAITING, field, "item 0 (a test's entry)")
    with pytest.raises(NotImplementedError, match=f"{field}=.*ROADMAP"):
        Model(cfg, device="cpu")


def test_reset_parameters_is_seeded():
    """The constructor draws from a generator seeded 0; another seed
    gives other weights, normal(0, 0.02), with norm scales at one and
    biases at zero."""
    cfg = get_arch("qwen2.5-3b-smoke")
    a, b = Model(cfg, device="cpu"), Model(cfg, device="cpu")
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    b.reset_parameters(torch.Generator().manual_seed(1))
    attn = b.blocks[0]["attn"]
    assert not torch.equal(a.blocks[0]["attn"]["wq"], attn["wq"])
    assert abs(float(attn["wq"].detach().std()) - 0.02) < 2e-3
    assert torch.equal(b.blocks[0]["ln1"]["scale"], torch.ones(cfg.d_model))
    assert torch.equal(attn["bq"], torch.zeros_like(attn["bq"]))
