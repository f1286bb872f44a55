"""LM block families with a second input: the port's VLM
(llama-3.2-vision-90b: image cross attention with its tanh gate and the
cross cache) and audio encoder-decoder (whisper-tiny: layernorm, the
gelu MLP with biases, the non-causal encoder, decoder blocks with their
``xk``/``xv`` cache) against the reference's, at ``-smoke`` size.

The same comparisons and tolerances as ``test_torch_families`` (whose
helpers this file imports): forward logits and aux, prefill logits and
caches, every decode step, ``Model.loss`` with its gradients, greedy
tokens in fp32, the serving invariant on the port alone; then the
layers these families add, each against the reference's: layernorm and
the gelu MLP element for element, cross attention with a bf16 cache
under fp32 compute, the encoder's output, and the gate that lets the
image reach the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro_torch.models import Model
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.convert import lm_params_from_reference
from test_torch_families import (DTYPES, check_decode, check_forward,
                                 check_greedy, check_loss_and_grads,
                                 check_prefill,
                                 check_prefill_decode_matches_forward,
                                 inputs, make_batch, pair)

MULTIMODAL = ["llama-3.2-vision-90b", "whisper-tiny"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MULTIMODAL)
def test_forward_matches_reference(name, dtype):
    check_forward(name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MULTIMODAL)
def test_prefill_matches_reference(name, dtype):
    check_prefill(name, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MULTIMODAL)
def test_decode_matches_reference(name, dtype):
    check_decode(name, dtype)


@pytest.mark.parametrize("name", MULTIMODAL)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", MULTIMODAL)
def test_greedy_tokens_equal_reference_fp32(name):
    check_greedy(name)


@pytest.mark.parametrize("name", MULTIMODAL)
def test_prefill_decode_matches_forward(name):
    check_prefill_decode_matches_forward(name)


def _block(params, group, g=0):
    return jax.tree.map(lambda a: a[g], params["groups"][group])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_and_gelu_mlp_match_reference(dtype):
    """whisper's first decoder block: layernorm (eps 1e-5, with its
    bias) and the gelu MLP (tanh approximation, biases) on one input.
    fp32: 1e-6.  bf16: the norm element for element (at most 1% of the
    elements a rounding apart); the MLP within 2^-7 of its largest
    output: the reference's ``jax.nn.gelu`` rounds each of its eight ops
    to bf16 (its constants too), ``F.gelu(approximate="tanh")`` once, so
    20% of the MLP's outputs differ (CPU: by at most 9.8e-4 against
    outputs up to 0.309, 2^-8.3 of it)."""
    rcfg, params, model = pair("whisper-tiny", dtype)
    blk = _block(params, "b0_dec")
    x = np.random.default_rng(7).standard_normal((2, 12, rcfg.d_model))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(x, jdt)
    want_h = ref_layers.norm(rcfg, blk["ln2"], x)
    want = np.asarray(ref_layers.mlp(rcfg, blk["mlp"], want_h), np.float32)
    want_h = np.asarray(want_h, np.float32)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        h = layers.norm(model.cfg, model.blocks[0]["ln2"], _t(x).to(tdt))
        got = layers.mlp(model.cfg, model.blocks[0]["mlp"], _t(want_h).to(
            tdt))
    assert h.dtype == got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        return
    frac = float(np.mean(want_h != h.float().numpy()))
    assert frac <= 0.01, f"norm: {frac:.3f} of elements differ"
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2 ** -7 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_with_cache_matches_reference(dtype):
    """The VLM cross block's attention against a bf16 cross cache (the
    decode path) and against projected image tokens (the prefill path):
    the port casts the cached keys and values to q's dtype, the
    reference's dense path promotes; outputs agree (fp32 1e-5, bf16
    2e-2) and the projected keys and values agree."""
    rcfg, params, model = pair("llama-3.2-vision-90b", dtype)
    kind = rcfg.pattern.index("cross")
    blk = _block(params, f"b{kind}_cross")["xattn"]
    port = model.blocks[kind]["xattn"]
    rng = np.random.default_rng(8)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    x = jnp.asarray(rng.standard_normal((2, 3, rcfg.d_model)), jdt)
    img = jnp.asarray(rng.standard_normal((2, 8, rcfg.d_model)), jdt)
    tol = 1e-5 if dtype == "float32" else 2e-2
    want, want_kv = ref_layers.cross_attention(rcfg, blk, x, img)
    with torch.no_grad():
        got, kv = layers.cross_attention(model.cfg, port, _t(x).to(tdt),
                                         _t(img).to(tdt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        want, np.float32), rtol=tol, atol=tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(kv[key].float().numpy(), np.asarray(
            want_kv[key], np.float32), rtol=tol, atol=tol)
    ck = jnp.asarray(want_kv["k"], jnp.bfloat16)
    cv = jnp.asarray(want_kv["v"], jnp.bfloat16)
    want, _ = ref_layers.cross_attention(rcfg, blk, x[:, :1], None,
                                         kv=(ck, cv))
    with torch.no_grad():
        got, _ = layers.cross_attention(
            model.cfg, port, _t(x[:, :1]).to(tdt), None,
            kv=(_t(ck).bfloat16(), _t(cv).bfloat16()))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        want, np.float32), rtol=tol, atol=tol)


def test_encoder_output_matches_reference():
    """whisper's encoder (``in_proj``, the non-causal ``"enc"`` stack, its
    final norm) in the prefill's context equals the reference's, fp32,
    and the decode context computes no encoder."""
    rcfg, params, model = pair("whisper-tiny", "float32")
    batch = inputs(make_batch(model.cfg))
    want = ref_transformer._context(rcfg, params, {
        "audio_embeds": jnp.asarray(batch["audio_embeds"])}, "prefill",
        "xla")["enc_out"]
    with torch.no_grad():
        ctx = T._context(model.cfg, model, model._inputs(batch), "prefill",
                         "chain")
    assert ctx["enc_out"].shape == (2, model.cfg.encoder_seq,
                                    model.cfg.d_model)
    np.testing.assert_allclose(ctx["enc_out"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert set(T._context(model.cfg, model, model._inputs(batch), "decode",
                          "chain")) == {"mode", "impl"}


def test_cross_gate_lets_the_image_reach_the_logits():
    """With the cross block's gate at its init (zero, tanh(0) = 0) the
    image changes nothing; with the gate redrawn another image moves the
    logits, in both packages alike (fp32, 1e-4)."""
    rcfg, params, model = pair("llama-3.2-vision-90b", "float32")
    batch = inputs(make_batch(model.cfg))
    other = dict(batch, image_embeds=batch["image_embeds"][::-1].copy())
    a, b = model(batch), model(other)
    assert float((a - b).abs().max()) > 1e-3
    want, _ = ref_transformer.forward(rcfg, params, {
        k: jnp.asarray(v) for k, v in other.items()})
    np.testing.assert_allclose(b.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    closed = Model(model.cfg, device="cpu")
    closed.load_state_dict(lm_params_from_reference(model.cfg, params))
    for i, kind in enumerate(model.cfg.layer_kinds()):
        if kind == "cross":
            with torch.no_grad():
                closed.blocks[i]["gate"].zero_()
    torch.testing.assert_close(closed(batch), closed(other), rtol=0, atol=0)


def test_decoder_caches_keep_the_encoder_heads():
    """whisper's decoder caches: ``xk``/``xv`` over ``encoder_seq``
    positions with ``n_heads`` heads, not padded by ``pad_caches``; the
    self-attention ``k``/``v`` padded."""
    from repro_torch.models.kvcache import pad_caches
    _, _, model = pair("whisper-tiny", "float32")
    cfg = model.cfg
    _, caches = model.prefill(inputs(make_batch(cfg), 6))
    caches = pad_caches(cfg, caches, 4)
    for c in caches:
        assert c["xk"].shape == (2, cfg.encoder_seq, cfg.n_heads, cfg.dh)
        assert c["xv"].dtype == torch.bfloat16
        assert c["k"].shape == (2, 10, cfg.n_kv_heads, cfg.dh)
