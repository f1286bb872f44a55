"""How far decode drifts from the full forward, and how far a broken
decode would: qwen2.5-3b at full width and depth on one GPU, weights from
a generator seeded 0, four 2048-token prompts from ``data/tokens.py``,
then 31 decode steps of seeded random tokens, in fp32 and in bf16
compute.  Each decode step's logits are held against the full forward's
at the same position, first with the port's ``decode_attention``, then
with one of six planted faults in it: the current token masked out
(``mask_lt``), its rope one position early, its key and value written
one slot early, its key written unroped, the score left unscaled, and
the GQA head map transposed.  It prints the largest error over the steps
and the smallest and median per-step largest error.  chip_smoke.py's
``LM_DECODE_TOL_FP32`` sits between the correct decode's reading and the
faults'.

Usage, from the repo root on a machine with a CUDA GPU:

    python3 scripts/lm_decode_faults.py
"""
import dataclasses
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.tokens import DataConfig, batch_at  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.kvcache import pad_caches  # noqa: E402

good = L.decode_attention

def make(fault):
    """``decode_attention`` with ``fault`` planted in it."""
    def dec(cfg, p, x, cache, pos):
        dt = L.cdt(cfg)
        b = x.shape[0]
        q, k_new, v_new = L._proj_qkv(cfg, p, x)
        rp = pos - 1 if fault == "rope_pos-1" else pos
        positions = torch.tensor([rp], device=x.device)
        q = L.rope(q, positions, cfg.rope_theta)
        if fault != "k_unroped":
            k_new = L.rope(k_new, positions, cfg.rope_theta)
        k, v = cache["k"], cache["v"]
        S = k.shape[1]
        slot = min(pos, S - 1) - (1 if fault == "slot_pos-1" else 0)
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        mask = torch.arange(S, device=x.device) < pos if fault == "mask_lt" \
            else torch.arange(S, device=x.device) <= pos
        hkv, dh = k.shape[2], q.shape[-1]
        g = cfg.n_heads // hkv
        if fault == "gqa_mod":
            qq = q.reshape(b, 1, g, hkv, dh).transpose(2, 3).float()
        else:
            qq = q.reshape(b, 1, hkv, g, dh).float()
        sc = torch.einsum("bthgd,bshd->bhgts", qq, k.float())
        if fault != "no_scale":
            sc = sc / math.sqrt(dh)
        sc = torch.where(mask, sc, -1e30)
        pr = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgts,bshd->bthgd", pr, v.float())
        if fault == "gqa_mod":
            o = o.transpose(2, 3)
        o = o.reshape(b, 1, cfg.n_heads, dh).to(dt)
        out = torch.einsum("bthk,hkd->btd", o, p["wo"].to(dt))
        return out, cache
    return dec

dev = torch.device("cuda")
base = get_arch("qwen2.5-3b")
model = Model(base, device=dev)
model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
B, T, N = 4, 2048, 32
prompt = torch.from_numpy(batch_at(DataConfig(vocab=base.vocab, seq_len=T,
                          global_batch=B, seed=0), 0)["tokens"]).to(dev)
toks = torch.randint(0, base.vocab, (B, N), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
for dtc in ("float32", "bfloat16"):
    model.cfg = dataclasses.replace(base, dtype_compute=dtc)
    t0 = time.perf_counter()
    full = model({"tokens": torch.cat([prompt, toks[:, :-1]], 1)})
    want = full[:, T - 1:].clone(); del full
    torch.cuda.synchronize()
    print(f"{dtc}: forward {time.perf_counter()-t0:.2f} s, logit std "
          f"{float(want.std()):.3f} max|.| {float(want.abs().max()):.3f}", flush=True)
    for fault in ("none", "mask_lt", "rope_pos-1", "slot_pos-1", "k_unroped",
                  "no_scale", "gqa_mod"):
        L.decode_attention = good if fault == "none" else make(fault)
        t0 = time.perf_counter()
        lg, caches = model.prefill({"tokens": prompt})
        caches = pad_caches(model.cfg, caches, N)
        steps = [lg]
        for i in range(N - 1):
            lg, caches = model.decode(caches, toks[:, i:i + 1], T + i)
            steps.append(lg)
        del caches
        steps = torch.stack(steps, 1)
        d = (steps - want).abs()
        per = d[:, 1:].amax(dim=(0, 2))
        print(f"  {dtc} {fault:11s}: decode-step max abs {float(d[:, 1:].max()):.5f}"
              f" (prefill step {float(d[:, 0].max()):.5f}), per-step min "
              f"{float(per.min()):.5f} median {float(per.median()):.5f}, "
              f"excess rel0.25 {float((d - 0.25*(1+want.abs())).max()):.4f}"
              f" [{time.perf_counter()-t0:.1f} s]", flush=True)
    L.decode_attention = good
print("peak GiB", torch.cuda.max_memory_allocated() / 2**30)
