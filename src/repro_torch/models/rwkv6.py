"""RWKV-6 ("Finch") block: data-dependent-decay linear attention, chunked.

The counterpart of the reference's ``repro/models/rwkv6.py``, one einsum
for one einsum: the per-token recurrence

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t            (per head, (Dk, Dv) state)
    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

is evaluated chunk by chunk (:func:`rwkv_time_mix`, reference
``:53-124``): within a chunk of ``CHUNK`` steps the interaction matrix
factors into dense einsums over cumulative log decays, the carried
state enters through one more, and the state update is a third; the
chunks run in order.  The per-step log decay is clipped to
``>= -e^_W_CLIP`` so the chunk's exponentials stay finite in fp32.
The channel mix (``:127-135``) and the one-token step used in decode
(:func:`rwkv_time_mix_step`, ``:138-165``) follow.  The reference's
simplifications are kept: static token-shift mixing, a dense decay
projection, an RMS-style output norm instead of GroupNorm.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import cdt

CHUNK = 32
_W_CLIP = 0.5  # clip on exp-arg: per-step log-decay >= -e^0.5 ≈ -1.65


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1}, with ``prev`` = last token of previous segment."""
    prev = torch.zeros_like(x[:, :1]) if prev is None \
        else prev[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _heads(x: torch.Tensor, dh: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, d // dh, dh).transpose(1, 2)       # (B,H,T,dh)


def _out(p, y: torch.Tensor, g: torch.Tensor, dt) -> torch.Tensor:
    """Per-channel output norm (GroupNorm stand-in), gate, projection."""
    y = y * torch.rsqrt((y ** 2).mean(-1, keepdim=True) + 1e-6)
    y = (y * p["gn_scale"]).to(dt) * g
    return y @ p["wo"].to(dt)


def rwkv_time_mix(cfg: ArchConfig, p, x: torch.Tensor, *,
                  state: Optional[torch.Tensor] = None,
                  shift_prev: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: normed (B, T, D).  Returns (out, new_state, new_shift)."""
    dt = cdt(cfg)
    B, T, D = x.shape
    dh = cfg.rwkv_head_dim
    H = D // dh
    xs = _shift(x, shift_prev)
    r = _heads(_mix(x, xs, p["mu_r"]) @ p["wr"].to(dt), dh)
    k = _heads(_mix(x, xs, p["mu_k"]) @ p["wk"].to(dt), dh)
    v = _heads(_mix(x, xs, p["mu_v"]) @ p["wv"].to(dt), dh)
    g = F.silu(_mix(x, xs, p["mu_g"]) @ p["wg"].to(dt))
    w_arg = (_mix(x, xs, p["mu_w"]).float() @ p["ww"].float()) \
        + p["w_bias"]
    logw = -torch.exp(torch.clamp(w_arg, -8.0, _W_CLIP))     # (B,T,D) <= 0
    logw = _heads(logw, dh)                                   # (B,H,T,dh)
    u = p["u"].reshape(H, dh).float()
    r, k, v = r.float(), k.float(), v.float()
    if hasattr(r, "device_mesh"):
        y, S = _on_local_heads(r, k, v, logw, u, state)
    else:
        y, S = _chunks(r, k, v, logw, u, state)
    y = y.transpose(1, 2).reshape(B, T, D)
    return _out(p, y, g, dt), S, x[:, -1].float()


def _chunks(r, k, v, logw, u, state):
    """The chunk loop: r, k, v, logw (B, H, T, dh) fp32, u (H, dh), the
    carried state (B, H, dh, dh) or None (zeros) -> y (B, H, T, dh) and
    the last state."""
    B, H, T, dh = r.shape
    S = state if state is not None else torch.zeros(
        (B, H, dh, dh), dtype=torch.float32, device=r.device)
    L = min(CHUNK, T)
    nC = -(-T // L)
    pad = nC * L - T
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v, logw))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    ys = []
    # split, not sliced a chunk at a time: split's backward is one cat,
    # where each slice's backward would write a whole (B, H, T, dh)
    # gradient (bytes quadratic in the chunk count)
    for rc, kc, vc, lwc in zip(*(a.split(L, dim=2)
                                 for a in (r, k, v, logw))):  # (B,H,L,dh)
        lp = torch.cumsum(lwc, dim=2)                         # inclusive
        lp_prev = lp - lwc                                    # exclusive
        q_ = rc * torch.exp(lp_prev)
        k_ = kc * torch.exp(-lp)
        A = torch.einsum("bhtd,bhsd->bhts", q_, k_)
        A = torch.where(tri, A, 0.0)
        diag = torch.einsum("bhtd,bhtd,hd->bht", rc, kc, u)
        y = torch.einsum("bhts,bhse->bhte", A, vc)
        y = y + torch.einsum("bhtd,bhde->bhte", q_, S)        # carry term
        y = y + diag[..., None] * vc
        lpL = lp[:, :, -1:, :]                                # (B,H,1,dh)
        kd = kc * torch.exp(lpL - lp)
        S = torch.exp(lpL[:, :, 0, :, None]) * S + \
            torch.einsum("bhsd,bhse->bhde", kd, vc)
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :T], S


def _on_local_heads(r, k, v, logw, u, state):
    """:func:`_chunks` of DTensors, on each rank's own rows and heads
    through ``local_map``: a head's recurrence reads no other head and a
    row's no other row, so the loop runs on the local tensors, one op a
    step where each DTensor op would be a dispatch of its own.  The batch
    is split over the data (and pod) axes as the batch is, the heads
    over ``"model"`` when that divides them (else every rank of the axis
    runs all heads); u's gradient comes back partial over the batch's
    axes (each rank's rows' share)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..sharding import rules

    mesh = r.device_mesh
    names = mesh.mesh_dim_names
    b, h = r.shape[:2]
    m = mesh.size(names.index("model")) if "model" in names else 1
    split = m > 1 and h % m == 0
    batch_axes = rules.batch_sharding(mesh, b)
    batch_axes = rules.target_axes(batch_axes[0]) if batch_axes else ()
    rows = [Shard(0) if n in batch_axes else
            Shard(1) if n == "model" and split else Replicate()
            for n in names]
    heads = [Shard(0) if n == "model" and split else Replicate()
             for n in names]
    u_grad = [Partial() if n in batch_axes else pl
              for n, pl in zip(names, heads)]
    s_place = None if state is None else rows
    return local_map(_chunks, out_placements=(rows, rows),
                     in_placements=(rows, rows, rows, rows, heads, s_place),
                     in_grad_placements=(rows, rows, rows, rows, u_grad,
                                         s_place),
                     device_mesh=mesh, redistribute_inputs=True)(
        r, k, v, logw, u, state)


def rwkv_channel_mix(cfg: ArchConfig, p, x: torch.Tensor, *,
                     shift_prev: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = cdt(cfg)
    xs = _shift(x, shift_prev)
    k = _mix(x, xs, p["c_mu_k"]) @ p["c_wk"].to(dt)
    k = torch.square(torch.relu(k))
    rgate = torch.sigmoid(_mix(x, xs, p["c_mu_r"]) @ p["c_wr"].to(dt))
    return (k @ p["c_wv"].to(dt)) * rgate, x[:, -1].float()


def rwkv_time_mix_step(cfg: ArchConfig, p, x: torch.Tensor, *,
                       state: torch.Tensor, shift_prev: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrence (decode).  x: (B, 1, D)."""
    dt = cdt(cfg)
    B, _, D = x.shape
    dh = cfg.rwkv_head_dim
    H = D // dh
    xs = shift_prev[:, None].to(x.dtype)

    def proj(mu, w):
        return (_mix(x, xs, p[mu]) @ p[w].to(dt))[:, 0]

    r = proj("mu_r", "wr").reshape(B, H, dh).float()
    k = proj("mu_k", "wk").reshape(B, H, dh).float()
    v = proj("mu_v", "wv").reshape(B, H, dh).float()
    g = F.silu(proj("mu_g", "wg"))
    w_arg = ((_mix(x, xs, p["mu_w"]).float() @ p["ww"].float())
             + p["w_bias"])[:, 0]
    w = torch.exp(-torch.exp(torch.clamp(w_arg, -8.0, _W_CLIP))) \
        .reshape(B, H, dh)
    u = p["u"].reshape(H, dh).float()
    kv = torch.einsum("bhd,bhe->bhde", k, v)
    y = torch.einsum("bhd,bhde->bhe", r, state + u[None, :, :, None] * kv)
    state = w[..., None] * state + kv
    return _out(p, y.reshape(B, 1, D), g[:, None], dt), state, \
        x[:, -1].float()
