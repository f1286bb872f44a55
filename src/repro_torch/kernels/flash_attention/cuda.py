"""CUDA flash attention: the wrapper around
``csrc/flash_attention.cu::ctj_flash_attention``.

Replaces the reference's Pallas kernel
(``repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``).
The kernel takes contiguous bf16 or fp32 q (B, T, H, Dh) and k, v
(B, S, Hkv, Dh) of one dtype, with Dh one of :data:`HEAD_DIMS` and
H % Hkv == 0, and in bf16 each at a 16-byte aligned address (the
kernel copies rows in 16-byte pieces); the wrapper raises on anything
else (a non-contiguous input included: the caller makes it contiguous,
nothing is copied here), allocates the output with ``torch.empty`` and
launches on PyTorch's current stream.  It has no plain fallback: a failed launch
raises.  ``launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import cudalib

__all__ = ["flash_attention", "launches", "HEAD_DIMS", "DTYPES"]

# every head dim of the reference's kernel sweep and arch configs
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
DTYPES = (torch.bfloat16, torch.float32)

launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q over k, v on the card (shapes and masks as
    ``plain.flash_attention``)."""
    global launches
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: kernel "
                         "takes (B, T, H, Dh) and (B, S, Hkv, Dh)")
    b, t, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q: {q.dtype}, kernel takes {DTYPES}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads over {hkv} KV heads")
    if s < 1 or t * h >= 2 ** 31:
        raise ValueError(f"T = {t}, S = {s}, H = {h}: kernel takes S >= 1 "
                         "and T * H < 2^31")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: kernel takes window >= 1")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset}: kernel takes q_offset >= 0")
    dev = q.device
    P = cudalib.ptr
    ptrs = (P(q, "q", dev, q.dtype, (b, t, h, dh)),
            P(k, "k", dev, q.dtype, (b, s, hkv, dh)),
            P(v, "v", dev, q.dtype, (b, s, hkv, dh)))
    if q.dtype == torch.bfloat16 and any(p % 16 for p in ptrs):
        raise ValueError("q, k, v: bf16 kernel takes 16-byte aligned "
                         "addresses")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_flash_attention(
            *ptrs, out.data_ptr(), b, t, s, h, hkv, dh,
            int(q.dtype == torch.bfloat16), int(causal),
            -1 if window is None else window, q_offset,
            1.0 / math.sqrt(dh), cudalib.stream_ptr(q))
    cudalib.check(err, "ctj_flash_attention")
    launches += 1
    return out
