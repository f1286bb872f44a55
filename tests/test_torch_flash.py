"""Flash attention: the port's three paths against the reference's.

The same numpy-seeded q, k, v go through the reference's
``flash_attention`` (``impl="ref"``, ``"xla"`` and ``"pallas"``, the
last in interpret mode as its own tests run it) and the port's
(``"fused"`` on a CPU tensor, which runs ``plain.py``; ``"chain"``;
``"ref"``).  bf16 inputs are the same fp32 draws rounded to bf16 on both
sides (both round to nearest even).  The tolerances are the reference
sweep's (``tests/test_kernels.py``): 2e-5 in fp32 and 2e-2 in bf16,
absolute and relative, since each path sums in its own order and bf16
outputs may round to neighbouring values.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro_torch.convert import ATTENTION_IMPLS
from repro_torch.kernels.flash_attention import ops, plain, ref

CASES = [
    # b, t, s, h, hkv, dh, causal, window, q_offset (the reference sweep)
    (1, 8, 8, 4, 2, 16, True, None, 0),
    (2, 16, 16, 4, 4, 32, True, None, 0),
    (1, 8, 24, 4, 1, 16, True, None, 16),
    (2, 32, 32, 6, 2, 16, True, 8, 0),
    (1, 16, 16, 4, 2, 16, False, None, 0),
    (2, 1, 40, 8, 2, 64, True, None, 39),
    (1, 24, 24, 2, 2, 128, True, 16, 0),
    # qwen2.5-3b's heads: H = 16 over Hkv = 2, Dh = 128
    (1, 64, 64, 16, 2, 128, True, None, 0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BLOCKS = dict(block_q=8, block_k=8)   # the reference sweep's tiles


def _inputs(case):
    b, t, s, h, hkv, dh = case[:6]
    rng = np.random.default_rng(list(case[:6]) + [case[6], case[7] or 0,
                                                  case[8]])
    return (rng.standard_normal((b, t, h, dh), dtype=np.float32),
            rng.standard_normal((b, s, hkv, dh), dtype=np.float32),
            rng.standard_normal((b, s, hkv, dh), dtype=np.float32))


def _masks(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8])


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """The reference's three outputs, as fp32 numpy."""
    q, k, v = (jnp.asarray(x, getattr(jnp, dtype)) for x in _inputs(case))
    out = {}
    for impl in ("ref", "xla", "pallas"):
        kw = {} if impl == "ref" else BLOCKS
        got = ref_ops.flash_attention(q, k, v, impl=impl, **_masks(case),
                                      **kw)
        out[impl] = np.asarray(got, np.float32)
    return out


def _port(case, dtype, impl, **kw):
    q, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in _inputs(case))
    got = ops.flash_attention(q, k, v, impl=impl, **_masks(case), **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    return got.float().numpy()


@pytest.mark.parametrize("impl", ["fused", "chain", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_port_matches_reference(case, dtype, impl):
    got = _port(case, dtype, impl, **({} if impl == "ref" else BLOCKS))
    tol = TOL[dtype]
    for ref_impl, want in _reference(case, dtype).items():
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=f"port {impl} vs reference "
                                   f"{ref_impl} {case}")


@pytest.mark.parametrize("blocks", [(5, 7), (512, 1024), (3, 40)])
@pytest.mark.parametrize("case", [CASES[3], CASES[5], CASES[6]])
def test_plain_blocks_do_not_change_the_result(case, blocks):
    """Ragged tiles, one tile, and tiles that leave a row's first kv
    tile wholly outside its window: the dense oracle's answer in fp32."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(case))
    got = plain.flash_attention(q, k, v, **_masks(case),
                                block_q=blocks[0], block_k=blocks[1])
    want = ref.attention_ref(q, k, v, **_masks(case))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_impl_names():
    assert set(ATTENTION_IMPLS.values()) == set(ops.IMPLS)
    q = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="attention impl"):
        ops.flash_attention(q, q, q, impl="pallas")


def _tensor_core_model(q, k, v, *, causal, window, q_offset):
    """The arithmetic of the CUDA kernel's bf16 path
    (``csrc/flash_attention.cu::flash_fwd_tc``), written out on the CPU:
    CTAs of 128 flattened (position, query head) rows of one KV head's
    group (64 at Dh >= 160), kv tiles of 64 keys (32 at Dh = 256) from
    the first key some row of the CTA sees, q, k and v rounded to bf16, Q·Kᵀ summed in fp32,
    scores in base 2, -1e30 where masked, p rounded to bf16 for the P·V
    product only, l summed from the fp32 p.  Returns the fp32 output
    before its rounding to bf16."""
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    keys = 32 if dh > 160 else 64
    cta = 128 if dh <= 128 else 64
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    scale = math.log2(math.e) / math.sqrt(dh)
    out = torch.zeros(b, t, h, dh)
    for f0 in range(0, t * g, cta):
        f = torch.arange(f0, min(f0 + cta, t * g))
        pos, head = f // g, f % g
        qpos = q_offset + pos
        k_end = min(s, int(qpos.max()) + 1) if causal else s
        k_begin = max(0, int(qpos.min()) - window + 1) if window else 0
        for bb in range(b):
            for hk in range(hkv):
                rows = qf[bb, pos, hk * g + head]
                m = torch.full((len(f),), -1e30)
                l = torch.zeros(len(f))
                acc = torch.zeros(len(f), dh)
                for k0 in range(k_begin, k_end, keys):
                    kpos = torch.arange(k0, k0 + keys)
                    inb = kpos < s
                    kt = torch.zeros(keys, dh)
                    vt = torch.zeros(keys, dh)
                    kt[inb] = kf[bb, kpos[inb], hk]
                    vt[inb] = vf[bb, kpos[inb], hk]
                    sc = (rows @ kt.T) * scale
                    ok = inb[None, :].expand(len(f), keys)
                    if causal:
                        ok = ok & (kpos[None, :] <= qpos[:, None])
                    if window:
                        ok = ok & (kpos[None, :] > qpos[:, None] - window)
                    sc = torch.where(ok, sc, -1e30)
                    mx = torch.maximum(m, sc.amax(1))
                    alpha = torch.exp2(m - mx)
                    p = torch.exp2(sc - mx[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + \
                        p.to(torch.bfloat16).float() @ vt
                    m = mx
                out[bb, pos, hk * g + head] = acc / l.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("case", CASES)
def test_tensor_core_numerics_fit_the_tolerance(case):
    """The bf16 kernel's one numerical change from the reference, p
    rounded to bf16 before P·V, keeps it within the bf16 tolerance of the
    plain version on every case; and the model does differ from it (the
    fp32 outputs before rounding), so the check is not vacuous."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(case))
    model = _tensor_core_model(q, k, v, **_masks(case))
    exact = plain.flash_attention(q.float(), k.float(), v.float(),
                                  **_masks(case))
    assert float((model - exact).abs().max()) > 0
    want = plain.flash_attention(q, k, v, **_masks(case)).float()
    tol = TOL["bfloat16"]
    torch.testing.assert_close(model.to(torch.bfloat16).float(), want,
                               rtol=tol, atol=tol)
