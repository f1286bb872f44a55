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

The kernel is a forward pass only, like the reference's Pallas kernel
(which has no ``custom_vjp``: the reference trains through its XLA
scan).  :class:`FlashAttention` carries gradients past it: its forward
launches the kernel and saves q, k and v, and its backward recomputes
``plain.flash_attention`` on them under autograd (the reference's one
differentiable flash path, rematerialised block by block) and returns
that function's gradients.  ``backward_calls`` counts those recomputes.
``ops.flash_attention`` launches through it on every CUDA tensor; where
autograd records nothing (grad mode off, as in serving, or no input
that requires grad) it is one launch and no more.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import cudalib
from . import plain

__all__ = ["flash_attention", "FlashAttention", "launches",
           "backward_calls", "HEAD_DIMS", "DTYPES"]

# every head dim of the reference's kernel sweep and arch configs
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
DTYPES = (torch.bfloat16, torch.float32)

launches = 0
backward_calls = 0


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


class FlashAttention(torch.autograd.Function):
    """The kernel under autograd: ``FlashAttention.apply(q, k, v, causal,
    window, q_offset)``.  Forward launches the kernel (one count of
    ``launches``); backward recomputes the plain blocked softmax on the
    saved inputs and differentiates it (one count of
    ``backward_calls``, no launch)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.masks = dict(causal=causal, window=window, q_offset=q_offset)
        return flash_attention(q, k, v, **ctx.masks)

    @staticmethod
    def backward(ctx, grad_out):
        global backward_calls
        backward_calls += 1
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_(w)
                      for x, w in zip(ctx.saved_tensors, wanted)]
            out = plain.flash_attention(*inputs, **ctx.masks)
            grads = iter(torch.autograd.grad(
                out, [x for x, w in zip(inputs, wanted) if w], grad_out))
        return tuple(next(grads) if w else None for w in wanted) + (
            None, None, None)
