"""Per-rank cost counts of a cell's step (two-point probe), with no card.

The counterpart of the reference's ``repro/launch/costprobe.py``.  The
reference reads XLA's cost analysis, which counts a while-loop body once,
so it compiles two reduced-depth variants of the cell with every scan
unrolled (``cfg.cost_exact``) and extrapolates.  The port's step is
Python: its layer, chunk and block loops run op by op, and
:class:`RankCounts` sees every op as it runs.  What is kept is the
extrapolation in the group count, for time (tracing a full-depth
rwkv6-7b ``train_4k`` takes ~1,550 s on the host, two groups seconds):

    C(full) = C(base) + (n_groups - 1) · (C(base+1group) - C(base))

exact for homogeneous group stacks (and for whisper, whose encoder layer
count equals its decoder group count, the encoder scales alongside); an
attention-free arch (family ``"ssm"``) at a long sequence runs at
``SSM_PROBE_SEQ`` tokens and twice that, extrapolated to T (every cost
is affine in T there: token mixing is chunk-local).  ``cost_exact``
takes the loss in one chunk, as the reference's does.

What is counted, per rank (the step runs once on the dry-run's fake
process group, ``dryrun.place_cell``, its tensors meta shards):

* FLOPs: ``torch.utils.flop_counter``'s formulas (FlopCounterMode's:
  matrix products, convolutions, attention ops) on each op of this
  rank's local tensors.  An op on DTensors is not counted as such: it
  is handed on to DTensor, whose local ops (this rank's shapes) come
  back here, so a sharded product counts this rank's share.  The flash
  kernel is a ctypes call on the card and ``dryrun.KernelAllocations``
  here, so its FLOPs are added by formula once a call (a remat
  recompute counts again): forward 4·B·H·Dh a (query, key) pair it
  attends (:func:`attention_flops`), backward what FlopCounterMode
  counts of the plain path's backward, which is what
  ``cuda.FlashAttention`` runs on the card
  (:func:`attention_backward_flops`);
* bytes: the inputs plus outputs of every op on local tensors (views
  and ``empty`` allocations aside), each op as if it read and wrote
  memory on its own: an upper bound of an unfused step;
* collectives: the result's local bytes of each collective the step
  issues (``_c10d_functional`` and ``c10d`` ops), by kind, as the
  reference counts them from the partitioned HLO.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs.base import ArchConfig
from ..kernels.flash_attention.plain import DEFAULT_BK, DEFAULT_BQ
from . import roofline as rl

SSM_PROBE_SEQ = 4096

# collective op names (``_c10d_functional.*`` and ``c10d.*``) -> kind
_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided")


def flash_pairs(t: int, s: int, causal: bool, window, q_offset: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    qpos = q_offset + np.arange(t, dtype=np.int64)
    hi = np.minimum(qpos, s - 1) if causal else np.full(t, s - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(t, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_flops(q_shape, k_shape, causal: bool = True, window=None,
                    q_offset: int = 0) -> int:
    """The flash kernel's forward: 4·B·H·Dh FLOPs (two products) for
    each (query, key) pair it attends."""
    b, t, h, dh = q_shape
    return 4 * b * h * dh * flash_pairs(t, k_shape[1], causal, window,
                                        q_offset)


def attention_backward_flops(q_shape, k_shape) -> int:
    """What FlopCounterMode counts of ``cuda.FlashAttention``'s backward
    (the plain blocked softmax recomputed on the saved inputs and
    differentiated, q, k and v all wanting gradients): every (block_q,
    block_k) block of the padded T_p x S_p rectangle, masked or not,
    18·B·H·Dh FLOPs a pair: the forward's two products (4 a pair)
    recomputed by the backward and by the q block's checkpoint, the kv
    step's checkpoint recomputing up to the scores (2), and each
    product's two gradients (8)."""
    b, t, h, dh = q_shape
    s = k_shape[1]
    bq, bk = min(DEFAULT_BQ, t), min(DEFAULT_BK, s)
    t_p, s_p = -(-t // bq) * bq, -(-s // bk) * bk
    return 18 * b * h * dh * t_p * s_p


@contextlib.contextmanager
def live_count() -> Iterator[Dict[str, int]]:
    """Count what runs inside on the card: FlopCounterMode's FLOPs plus
    the flash kernel's forward FLOPs by formula (:func:`attention_flops`)
    at each of its launches, which the counter cannot see (a ctypes
    call; the kernel's backward is the plain path, which it counts).
    Yields a dict whose ``flops`` (the total), ``kernel_flops`` and
    ``launches`` are complete on exit.  The numbers to hold a probe's
    (:func:`probe_costs`) against."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..kernels.flash_attention import cuda as flash_cuda
    real = flash_cuda.flash_attention
    out = dict(flops=0, kernel_flops=0, launches=0)

    def counted(q, k, v, causal=True, window=None, q_offset=0, **kw):
        out["kernel_flops"] += attention_flops(
            tuple(q.shape), tuple(k.shape), causal, window, q_offset)
        out["launches"] += 1
        return real(q, k, v, causal=causal, window=window,
                    q_offset=q_offset, **kw)

    flash_cuda.flash_attention = counted
    try:
        with FlopCounterMode(display=False) as fc:
            yield out
    finally:
        flash_cuda.flash_attention = real
    out["flops"] = fc.get_total_flops() + out["kernel_flops"]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return issubclass(t, FakeTensor)


class RankCounts(TorchDispatchMode):
    """FLOPs, bytes and collective bytes of every op on this rank's local
    tensors while it is on (see the module's notes); an op on DTensors is
    handed on to DTensor (``NotImplemented``), whose local ops come back
    here.  An op on fake tensors is DTensor's sharding propagation (it
    runs an op once at global shapes on ``FakeTensor``s, the first time
    it meets it, to learn the output's shape): not counted.
    :meth:`attention` adds a flash kernel call's FLOPs.  With
    ``collectives_only`` it counts the collectives alone."""

    def __init__(self, collectives_only: bool = False):
        super().__init__()
        self.collectives_only = collectives_only
        self.flops = 0
        self.bytes = 0
        self.per_op = {k: 0 for k in rl.COLLECTIVES}
        self.kernel_flops = 0

    def attention(self, q, k, kw: Dict, backward: bool = False) -> None:
        if backward:
            n = attention_backward_flops(tuple(q.shape), tuple(k.shape))
        else:
            n = attention_flops(tuple(q.shape), tuple(k.shape),
                                kw.get("causal", True), kw.get("window"),
                                kw.get("q_offset", 0))
        self.flops += n
        self.kernel_flops += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor(t) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(_is_fake(t) for t in types):
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d"):
            for key, kind in _KINDS:
                if key in name:
                    res = out if ns == "_c10d_functional" else args[0]
                    self.per_op[kind] += _nbytes(tree_flatten(res)[0])
                    break
            return out
        if self.collectives_only:
            return out
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if not func.is_view and name not in _FREE:
            self.bytes += _nbytes(tree_flatten((args, kwargs))[0]) \
                + _nbytes(tree_flatten(out)[0])
        return out

    def costs(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                **{f"coll_{k}": float(v) for k, v in self.per_op.items()}}


def cell_costs(cfg: ArchConfig, case, mesh, **place_kw) -> Dict[str, float]:
    """One rank's counts of the cell's step: ``dryrun.place_cell`` (on
    ``mesh``, a fake group's, or one process's meta tensors when None),
    run once under :class:`RankCounts` with attention as the kernel."""
    from . import dryrun
    _, _, run = dryrun.place_cell(cfg, case, mesh, **place_kw)
    counts = RankCounts()
    with counts, dryrun.attention_as_kernel(counts.attention):
        run()
    return counts.costs()


def _probe_cfg(cfg: ArchConfig, groups: int) -> ArchConfig:
    p = len(cfg.pattern)
    nl = groups * p + cfg.n_rem_layers
    kw = dict(n_layers=nl, cost_exact=True)
    if cfg.encoder_decoder:
        assert cfg.n_encoder_layers == cfg.n_groups, \
            "enc-dec probe assumes encoder layers == decoder groups"
        kw["n_encoder_layers"] = groups
    return dataclasses.replace(cfg, **kw)


def _groups(count, cfg: ArchConfig, case, mesh) -> tuple:
    """(counts at one group, at two groups, extrapolated to the config's
    group count)."""
    c1 = count(_probe_cfg(cfg, 1), case, mesh)
    c2 = count(_probe_cfg(cfg, 2), case, mesh)
    n = max(cfg.n_groups - 1, 0)
    return c1, c2, {k: c1[k] + n * (c2[k] - c1[k]) for k in c1}


def probe_costs(cfg: ArchConfig, case, mesh,
                count: Optional[Callable] = None) -> Dict:
    """Extrapolated per-rank totals for the full-depth cell: ``count(cfg,
    case, mesh)`` (:func:`cell_costs` by default; microbatches 1, as the
    reference's probe) at one and two groups.

    Attention-free archs (family == "ssm") at long sequence: every cost
    component is affine in T (token mixing is chunk-local with a fixed
    chunk; the first chunk, with no state to carry in, differs from the
    others by a constant), so the probe runs at ``SSM_PROBE_SEQ`` tokens
    and twice that and extrapolates to T (the reference scales one run
    by T/4096, exact for its scan, whose every chunk is the same).
    """
    count = count or cell_costs
    scale = 1.0
    points = {}
    probe_seq = SSM_PROBE_SEQ
    if cfg.family == "ssm" and case.kind != "decode" and case.seq > probe_seq:
        scale = case.seq / probe_seq
        long = dataclasses.replace(case, seq=2 * probe_seq)
        case = dataclasses.replace(case, seq=probe_seq)
        l1, l2, at_2p = _groups(count, cfg, long, mesh)
        points = {"one_group_2x_seq": l1, "two_groups_2x_seq": l2}
    c1, c2, out = _groups(count, cfg, case, mesh)
    if scale != 1.0:
        out = {k: out[k] + (scale - 1) * (at_2p[k] - out[k]) for k in out}
    per_op = {k[len("coll_"):]: v for k, v in out.items()
              if k.startswith("coll_")}
    return {"flops": out["flops"], "bytes": out["bytes"],
            "collectives": per_op, "seq_scale": scale,
            "probe_points": {"one_group": c1, "two_groups": c2, **points}}
