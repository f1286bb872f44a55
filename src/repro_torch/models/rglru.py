"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The counterpart of the reference's ``repro/models/rglru.py:107-177``:
the diagonal gated linear recurrence

    a_t = exp(-c · softplus(Λ) · σ(W_a x_t)),   c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (σ(W_i x_t) ⊙ x_t)

after a short causal depthwise conv, gated by a gelu branch.  The
reference evaluates the recurrence with ``jax.lax.associative_scan``
over time; here :func:`rglru_scan` is a log-depth scan in plain
PyTorch: ⌈log2 T⌉ doubling steps, each combining every position with
the one ``d`` before it by ``(a1·a2, a2·b1 + b2)``, instead of a
length-T loop.  A decode step (T = 1 with a cache) is
:func:`rglru_step`; decode carries (h, conv tail).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import cdt

_C = 8.0


def _conv1d(cfg: ArchConfig, p, x: torch.Tensor,
            state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over time.  x: (B, T, R).  Returns (out,
    new conv tail: the last ``conv_width - 1`` inputs)."""
    cw = cfg.conv_width
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * p["conv_w"][0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + t] * p["conv_w"][i].to(x.dtype)
    out = out + p["conv_b"].to(x.dtype)
    return out, xp[:, -(cw - 1):]


def _gates(p, xc: torch.Tensor):
    f32 = xc.float()
    r = torch.sigmoid(f32 @ p["wa"].float())
    i = torch.sigmoid(f32 @ p["wi"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) \
        * (i * f32)
    return a, b


def rglru_scan(cfg: ArchConfig, p, xc: torch.Tensor,
               h0: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence recurrence.  xc: (B, T, R) conv output.
    Returns (h over time (B, T, R) fp32, final state (B, R))."""
    a, b = _gates(p, xc)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    d = 1
    while d < a.shape[1]:
        # position t absorbs the prefix ending at t - d: (a, b) of t
        # after (a, b) of t - d
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b, b[:, -1]


def rglru_step(cfg: ArchConfig, p, xc: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  xc: (B, 1, R)."""
    a, b = _gates(p, xc)
    h = a[:, 0] * h0.float() + b[:, 0]
    return h[:, None], h


def rglru_block(cfg: ArchConfig, p, x: torch.Tensor, *,
                cache: Optional[Dict] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Griffin recurrent block: (gelu gate branch) ⊙ (conv → RG-LRU).

    x: normed input (B, T, D).  Returns (out (B, T, D), the new cache
    {"h" fp32, "conv" in the cache's dtype}, or None without a cache).
    """
    dt = cdt(cfg)
    y = F.gelu(x @ p["wy"].to(dt), approximate="tanh")
    xb = x @ p["wx"].to(dt)
    conv_state = cache["conv"] if cache is not None else None
    h0 = cache["h"] if cache is not None else None
    xc, conv_tail = _conv1d(cfg, p, xb, conv_state)
    if cache is not None and x.shape[1] == 1:
        h, h_last = rglru_step(cfg, p, xc, h0)
    else:
        h, h_last = rglru_scan(cfg, p, xc, h0)
    out = (y * h.to(dt)) @ p["wout"].to(dt)
    new_cache = None
    if cache is not None:
        new_cache = {"h": h_last.float(),
                     "conv": conv_tail.to(cache["conv"].dtype)}
    return out, new_cache
