#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a),
holds every kernel against its plain PyTorch version on the card (the
tier-2 probe and insert at the static benchmark cell's shapes), runs
``engine.count`` and ``engine.evaluate`` of the 4-cycle on Zipf graphs at
the published scale of SNAP wiki-Vote and ca-GrQc, then payload-replay
evaluation (tier 2 on, cold and warm passes on one engine) and streamed
evaluation (``engine.evaluate_stream``) of the ca-GrQc-scale graph, then
the static executor (``StaticCLFTJ``: a count, and an evaluation cold and
warm, each one fixed-capacity pass) and the distributed count and
evaluation in four processes on the one card (a gloo process group; the
script starts them as ``chip_smoke.py --dist-worker RANK WORLD DIR``),
then the chain EXPAND with the leapfrog membership kernel
(``expand_kernel="chain", impl="leapfrog"``: a count at wiki-Vote scale,
an evaluation at ca-GrQc scale; and the reference's public bounded search
``registry.lower_bound`` / ``upper_bound`` with ``impl="leapfrog"``) and
the serving layer (``engine.serve``
with the ``GPU_SERVE`` preset: a plan-cache miss, an isomorphic hit that
replays warm tables, a count, four concurrent streams, a snapshot that a
fresh process, ``chip_smoke.py --serve-worker DIR``, loads and serves
warm from, and a server on the chain path), then the reference's knobs
(phase 15: the FOLD and EMIT op chains, ``fold_kernel="chain",
emit_kernel="chain"``, in a one-shot evaluation, a payload pass cold and
warm and a static evaluation cold and warm at ca-GrQc scale, against the
fused runs' rows; and the paper's host engines, ``backend="ref"``, on the
reference benchmark's ego-facebook-like graph beside the device engine),
checks every result against scipy.sparse oracles, and checks that each
path launched its kernels;
then LM serving (phase 14): the flash-attention kernel against its plain
version, and qwen2.5-3b at full width and depth (random weights from a
seed) prefilling four 2048-token prompts and decoding 32 greedy tokens
under ``greedy_generate``, checked against the plain attention path and
against a full forward; then training (phase 16): qwen2.5-3b at full
width and depth, the kernel's gradients (through the plain path in
backward) against the plain attention's in fp32 and bf16 compute beside
a planted fault, four AdamW steps of ``make_train_step`` on 4 x 2048
tokens in two microbatches, the three remat policies at one layer,
and the fault-tolerant loop (crash and resume from a checkpoint) at one
layer; then the other five block families (phase 17): recurrentgemma-2b
(RG-LRU and a local-attention ring), rwkv6-7b, phi3.5-moe and qwen3-moe
(depth cut to 4 and 2 layers), llama-3.2-vision (one pattern group of 5
layers, image cross attention) and whisper-tiny (the encoder-decoder),
each at full width with random weights, ``greedy_generate`` of 16
tokens, its flash launches counted, checked against ``impl="chain"`` and
against a full forward; then training over a mesh (phase 18):
qwen2.5-3b at full width, depth cut to 2 of 36 layers, on a (data 2,
model 2) mesh in four processes on the one card (a gloo group; the
script starts them as ``chip_smoke.py --mesh-worker RANK WORLD DIR``),
every collective DTensor calls probed on CUDA tensors, the mesh step in
fp32 and bf16 compute against the same steps in this process beside a
planted fault (the data-axis gradient all-reduce skipped), each rank's
flash launches, each rank's placed state bytes against the dry-run's on
a fake group, and the checkpoint restored onto (4, 1) by four fresh
processes bit for bit with its next step against the straight run's, and
the MoE (phi3.5-moe at full width, one of 32 layers, each rank holding 8
of its 16 experts) one step against one process beside a planted fault
(the load-balance loss from a rank's own means); then the cost tools
(phase 19): the two-point cost probe's FLOPs of phase 16's train step
(on meta tensors, no card) against FlopCounterMode's count of its first
step plus the flash kernel's formula, the step's FLOPs as a share of the card's peak, and the join's
dry-run (rank 0 of 256 of the distributed count on the card) against
the same shard on the CPU's plain path.  Phases print one line each; then come the
card's name and power limit (as nvidia-smi prints them), a JSON object
with each kernel's launches, error, times and bound, and as the last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without CUDA, and a worker that fails.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.paper_clftj import (  # noqa: E402
    BOUNDED_100K, GPU_EVAL_REPLAY, GPU_SERVE, PAPER_FAITHFUL,
    JoinEngineConfig)
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.cache import CacheConfig  # noqa: E402
from repro_torch.core import cache as cache_mod  # noqa: E402
from repro_torch.core.cached_frontier import CachedTrieJoin  # noqa: E402
from repro_torch.core.cq import CQ, cycle_query, path_query  # noqa: E402
from repro_torch.core.db import graph_db  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    StaticCLFTJ, make_distributed_count, make_distributed_evaluate,
    shard_frontier)
from repro_torch.core.frontier import Frontier  # noqa: E402
from repro_torch.core.hostsync import SyncCounter  # noqa: E402
from repro_torch.core.schedule import FOLD_CHILD  # noqa: E402
from repro_torch.data.graphs import dataset, zipf_graph  # noqa: E402
from repro_torch.kernels import cudalib, registry  # noqa: E402
from repro_torch.kernels.emit import cuda as emit_cuda  # noqa: E402
from repro_torch.kernels.emit import plain as emit_plain  # noqa: E402
from repro_torch.kernels.expand import chain as expand_chain  # noqa: E402
from repro_torch.kernels.expand import cuda as expand_cuda  # noqa: E402
from repro_torch.kernels.expand import plain as expand_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    cuda as flash_cuda, ops as flash_ops, plain as flash_plain)
from repro_torch.kernels.fold import cuda as fold_cuda  # noqa: E402
from repro_torch.kernels.fold import plain as fold_plain  # noqa: E402
from repro_torch.kernels.leapfrog import cuda as bound_cuda  # noqa: E402
from repro_torch.kernels.leapfrog import plain as bound_plain  # noqa: E402
from repro_torch.kernels.tier2 import cuda as tier2_cuda  # noqa: E402
from repro_torch.kernels.tier2 import plain as tier2_plain  # noqa: E402
from repro_torch.launch import costprobe  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.serve.canonical import rename_query  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.tokens import DataConfig, batch_at  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.kvcache import pad_caches  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.serve_step import (  # noqa: E402
    greedy_generate, greedy_logits)
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig, init_train_state, make_train_step)

C = 1 << 16                 # the main path's chunk capacity
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
# H100 SXM peak outside the tensor cores (the data sheet's float32 rate;
# it lists no int32 rate, and int32 issues no faster)
OPS_PER_S = 67e12
# H100 SXM dense bf16 tensor-core peak (the data sheet's): attention's
# bound, whatever units the kernel uses
TC_OPS_PER_S = 989e12
ZIPF_A = 0.8                # endpoint-popularity skew of both graphs
SEED = 0
# SNAP wiki-Vote: 7,115 vertices, 103,689 directed edges
WIKI = dict(nv=7115, ne=103689)
# SNAP ca-GrQc: 5,242 vertices, 14,496 undirected edges
GRQC = dict(nv=5242, ne=14496)
# the tier-2 cache of the reference's evaluation preset (TPU_EVAL_REPLAY
# in src/repro/configs/paper_clftj.py): 8-way set-associative tables of
# 2^14 slots, payload replay on, 2^17-row slab arenas
PAYLOAD_CACHE = CacheConfig(policy="setassoc", assoc=8, slots=1 << 14,
                            cache_payloads=True, payload_rows=1 << 17)
STREAM_IN_FLIGHT = 16       # the streaming preset's async-emit window
# the static executor's chunk: one chunk must hold the largest frontier
# of the pass.  At ca-GrQc scale the 4-cycle's last EXPAND enumerates
# 30,512,441 candidates (phase 10 prints the largest need), so 2^25.  At
# wiki-Vote scale it enumerates 299,760,871, which would need 2^29 rows
# a chunk (tens of GB each, several chunks live): there the static count
# runs at 2^24 and must flag its overflow
C_STATIC = 1 << 25
C_STATIC_WIKI = 1 << 24
DIST_WORLD = 4              # ranks of the distributed phase, on one card
DIST_TIMEOUT_S = 900
SERVE_WORKER_TIMEOUT_S = 300
SERVE_STREAMS = 4           # concurrent streaming sessions of the serve phase
# the leapfrog path: the chain EXPAND whose membership tests launch
# ctj_bound_atoms
CHAIN = dict(expand_kernel="chain", impl="leapfrog")
# phase 15: the FOLD and EMIT op chains (EXPAND stays on its kernel)
OP_CHAINS = dict(fold_kernel="chain", emit_kernel="chain")
# phase 11's knobs, passed explicitly to both factories (the defaults)
DIST_KNOBS = dict(expand_kernel="fused", impl="bsearch", fold_kernel="fused",
                  emit_kernel="fused")
# phase 15's host engines: the reference benchmark's dataset
# (benchmarks/bench_cycle_scaling.py) and its triangle
HOST_DATASET = "ego-facebook-like"
HOST_ALGORITHMS = ("clftj", "lftj", "ytd")
# kernel name -> (wrapper module, its launch counter)
WRAPPERS = {"expand": (expand_cuda, "launches"),
            "fold_replay": (fold_cuda, "launches"),
            "fold_splice": (fold_cuda, "splice_launches"),
            "fold_merged": (fold_cuda, "merged_launches"),
            "emit": (emit_cuda, "launches"),
            "bound": (bound_cuda, "launches"),
            "bound_atoms": (bound_cuda, "atoms_launches"),
            "flash_attention": (flash_cuda, "launches"),
            "tier2_probe": (tier2_cuda, "probe_launches"),
            "tier2_insert": (tier2_cuda, "insert_launches")}
SOURCES = {"expand": ("src/repro_torch/csrc/expand.cu",
                      "src/repro/kernels/expand/fused.py:193"),
           "fold_replay": ("src/repro_torch/csrc/fold.cu",
                           "src/repro/kernels/fold/fused.py:228"),
           "fold_splice": ("src/repro_torch/csrc/fold.cu",
                           "src/repro/kernels/fold/fused.py:228"),
           "fold_merged": ("src/repro_torch/csrc/fold.cu",
                           "src/repro/kernels/fold/fused.py:228"),
           "emit": ("src/repro_torch/csrc/emit.cu",
                    "src/repro/kernels/emit/fused.py:70"),
           "bound": ("src/repro_torch/csrc/leapfrog.cu",
                     "src/repro/kernels/leapfrog/leapfrog.py:56"),
           "bound_atoms": ("src/repro_torch/csrc/leapfrog.cu",
                           "src/repro/kernels/leapfrog/leapfrog.py:56"),
           "flash_attention": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention/flash_attention.py:74"),
           # no Pallas kernel: the reference's probe and insert are XLA
           "tier2_probe": ("src/repro_torch/csrc/tier2.cu",
                           "src/repro/core/cache.py:153"),
           "tier2_insert": ("src/repro_torch/csrc/tier2.cu",
                            "src/repro/core/cache.py:167")}
# the kernels only the static executor launches, only the leapfrog path
# (the chain EXPAND's membership test, the public bounded search), and
# only the LM (none of them the join's main path)
STATIC_ONLY = ("fold_merged",)
CHAIN_ONLY = ("bound", "bound_atoms")
LM_ONLY = ("flash_attention",)
# phase 14: qwen2.5-3b at full width and depth, four prompts of 2048
# tokens, 32 greedy tokens each
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 2048, 32
# the LM's tolerances, absolute and relative, on fp32 logits of standard
# deviation about 0.9 (random weights, normal(0, 0.02), width 2048).  In
# bf16 compute (the config's) two paths differ wherever a bf16 product or
# attention output rounds the other way (2^-8 relative), and through 36
# random layers such differences grow to about 0.2 at the logits: on an
# H100 this script read 0.1957 for decode vs the full forward (whose bf16
# KV cache the reference keeps too) and 0.1693 for fused vs chain
# prefill, against 5.8e-5 for fused vs chain in fp32 compute.  The
# reference allows 2e-3 and 5e-3 on its two-layer fp32 smoke configs
# (tests/test_serve.py).  LM_TOL is the bf16 bound, and the top-2 margin
# below which greedy tokens may differ; LM_TOL_FP32 bounds fused vs chain
# prefill logits in fp32 compute.  In fp32 compute decode differs from
# the full forward only by the bf16 KV cache: 0.053-0.061 read on an
# H100, against 0.27 or more at every step of a decode with a planted fault
# (the current token masked out, its key and value one slot early, its
# rope one position early, its key unroped, the score unscaled, the GQA
# head map transposed; scripts/lm_decode_faults.py), so
# LM_DECODE_TOL_FP32 is absolute and sits between.
LM_TOL = 0.25
LM_TOL_FP32 = 1e-3
LM_DECODE_TOL_FP32 = 0.1
# the kernel against its plain version: the reference sweep's seven
# cases (tests/test_kernels.py), qwen2.5-3b's prefill, a ragged length, a
# chunked prefill, stablelm-12b's head dim, phase 17's shapes and phase
# 18's.  b, t, s, h, hkv, dh, causal, window, q_offset
FLASH_CASES = [
    (1, 8, 8, 4, 2, 16, True, None, 0),
    (2, 16, 16, 4, 4, 32, True, None, 0),
    (1, 8, 24, 4, 1, 16, True, None, 16),
    (2, 32, 32, 6, 2, 16, True, 8, 0),
    (1, 16, 16, 4, 2, 16, False, None, 0),
    (2, 1, 40, 8, 2, 64, True, None, 39),
    (1, 24, 24, 2, 2, 128, True, 16, 0),
    (LM_BATCH, LM_PROMPT, LM_PROMPT, 16, 2, 128, True, None, 0),
    (1, 1000, 1000, 16, 2, 128, True, None, 0),
    (1, 1024, 2048, 16, 2, 128, True, None, 1024),
    (1, 512, 512, 32, 8, 160, True, None, 0),
    # phase 17's shapes: recurrentgemma's local prefill (twice the
    # window), the VLM's cross prefill and cross decode step, whisper's
    # encoder and its cross decode step
    (2, 4096, 4096, 10, 1, 256, True, 2048, 0),
    (1, 2048, 1601, 64, 8, 128, False, None, 0),
    (1, 1, 1601, 64, 8, 128, False, None, 0),
    (4, 1500, 1500, 6, 6, 64, False, None, 0),
    (4, 1, 1500, 6, 6, 64, False, None, 0),
    # phase 18's: one mesh rank's microbatch of qwen2.5-3b (a row of
    # MESH_BATCH / data 2 / MESH_MB, its 16 / 2 query heads over 2 / 2 KV
    # heads), and of the MoE case's phi3.5-moe (two rows of MESH_BATCH /
    # data 2 in one microbatch, its 32 / 2 query heads over 8 / 2 KV heads)
    (1, 2048, 2048, 8, 1, 128, True, None, 0),
    (2, 2048, 2048, 16, 4, 128, True, None, 0),
    # phase 18's moe-serve case: qwen3-moe-235b-a22b's prefill on one
    # rank (a row of MESH_SERVE_BATCH / data 2, or the first row alone,
    # its 64 / 2 query heads over 4 / 2 KV heads), and in the one process
    # it is held against (both rows, and the first alone, all heads)
    (1, 2048, 2048, 32, 2, 128, True, None, 0),
    (2, 2048, 2048, 64, 4, 128, True, None, 0),
    (1, 2048, 2048, 64, 4, 128, True, None, 0),
]
# the reference sweep's tolerance (absolute and relative): the kernel and
# the plain version sum in other orders; a bf16 output may round to a
# neighbouring value
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one call, by CUDA events recorded around it: from
    the call's start to the end of its last device op, host work that the
    device waits for (the wrapper's checks, allocations and launches)
    included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ops(prof) -> dict:
    """Each device op (kernel, copy, set) of a finished torch.profiler
    run: its name -> (seconds, records), the names with time only.  Read
    from the raw trace: ``key_averages()`` first builds the profiler's
    event tree, which took up to 16 s on a traced pass of tens of
    thousands of launches; its self device times are these sums."""
    from torch.autograd import DeviceType
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:      # a profiler without the raw trace
        return {e.key: (e.self_device_time_total / 1e6, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0}
    ops: dict = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            secs, n = ops.get(e.name(), (0.0, 0))
            ops[e.name()] = (secs + e.duration_ns() / 1e9, n + 1)
    return {k: v for k, v in ops.items() if v[0] > 0}


def busy_ops(fn, reps: int = 25) -> dict:
    """Device busy ms of one call by device op, from ``reps`` calls run
    under torch.profiler (the gaps in which the device waits for the host
    are left out): each op's mean time a record, times the records a
    call, ceil(records / reps).  Late in a long script the profiler kept
    only some of a run's device records (flash attention read 0.0428 ms
    busy there, 0.2663 in a fresh process); a mean a record and a count
    rounded up to whole calls stay right while fewer than ``reps``
    records of an op are lost."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {k: secs * 1e3 / n * -(-n // reps)
            for k, (secs, n) in device_ops(prof).items()}


def busy(fn, reps: int = 25) -> dict:
    """``busy_ms``, the device busy time of one call (its device ops'
    summed time), and ``busy_ops``, that time split by device op, from
    one profiled run."""
    ops = busy_ops(fn, reps)
    return dict(busy_ms=sum(ops.values()), busy_ops=ops)


def row_bytes(n: int, m: int) -> int:
    """Bytes of one chunk row's assign, factor, orig, lo and hi."""
    return 4 * n + 8 + 4 + 8 * m


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def trips(n: int) -> int:
    """Steps of the kernels' fixed-trip bounded search over n values."""
    return n.bit_length() + 1 if n else 0


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: the larger of the bytes moved
    over the memory rate and the integer operations (search steps and
    scanned values) over the peak rate outside the tensor cores."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def expand_work(F, g_col, g_rs, others, kw) -> tuple:
    """(bytes, operations) one EXPAND must spend on this input.  Bytes:
    the valid flags and the guard window of every valid row; the other
    atoms' windows of every row that fills a slot; the start and the
    candidate value of every guard run a filled slot takes; one column
    value per survivor and atom (capped at the column's length); the
    rest of every survivor's parent row; the survivors' rows, the valid
    flags and `needed` out.  Operations: two searches over the run starts
    per valid row, two scans of C values, and per filled slot the offset
    inversion and two searches per other atom."""
    C, n = F.assign.shape
    m = F.lo.shape[1]
    g_ai, n_oth = kw["g_ai"], len(others)
    valid, rs = host(F.valid), host(g_rs)
    r0 = np.searchsorted(rs, host(F.lo[:, g_ai]))
    r1 = np.searchsorted(rs, host(F.hi[:, g_ai]))
    cnt = np.where(valid, r1 - r0, 0)
    off = np.cumsum(cnt) - cnt
    filled = min(int(cnt.sum()), C)
    slot = np.arange(filled)
    src = np.searchsorted(off, slot, side="right") - 1
    runs = np.unique(r0[src] + slot - off[src]).size
    feeding = int(((cnt > 0) & (off < C)).sum())
    # survivors and their parents: the plain version on rows that carry
    # their own index in `orig`
    idx = F._replace(orig=torch.arange(C, dtype=torch.int32,
                                       device=F.orig.device))
    Fo, _ = expand_plain.expand_step(idx, g_col, g_rs, others, **kw)
    surv = int(Fo.valid.sum())
    parents = int(torch.unique(Fo.orig[:surv]).numel())
    read = (C + 8 * int(valid.sum()) + 8 * n_oth * feeding + 8 * runs
            + sum(4 * min(c.numel(), surv) for c in others)
            + parents * (4 * (n - 1) + 12 + 8 * (m - 1 - n_oth)))
    written = surv * row_bytes(n, m) + C + 4
    ops = (int(valid.sum()) * 2 * trips(rs.size) + 2 * C
           + filled * (trips(C) + sum(2 * trips(c.numel()) for c in others)))
    return read + written, ops


def fold_work(P, active, ror, E, d0: int, d1: int) -> tuple:
    """(bytes, operations) one replay-only FOLD must spend on this input.
    Bytes: the active flags and the representative of every active row;
    the exits' valid flags and the orig of every valid exit; the parent
    row (less the replayed columns) of every parent that fills an output
    row; columns [d0, d1] and the factor of every exit replayed; the
    output rows, the valid flags and the stats.  Operations: two searches
    over the exits per active row, one scan of C values, and per output
    row the offset inversion and the factor product."""
    C, n = P.assign.shape
    m, w = P.lo.shape[1], d1 - d0 + 1
    act = host(active)
    rep = np.clip(host(ror), 0, C - 1)
    ev = host(E.valid)
    ekey = np.where(ev, np.clip(host(E.orig), 0, C - 1), C)
    # each representative's exit range in the sorted keys, by counting
    ecnt = np.bincount(ekey, minlength=C + 1)[:C]
    lb = (np.cumsum(ecnt) - ecnt)[rep]
    ub = lb + ecnt[rep]
    pcnt = np.where(act, ub - lb, 0)
    roff = np.cumsum(pcnt) - pcnt
    take = np.clip(np.minimum(pcnt, C - roff), 0, None)
    feed = take > 0
    cover = np.zeros(C + 1, np.int64)
    np.add.at(cover, lb[feed], 1)
    np.add.at(cover, lb[feed] + take[feed], -1)
    exits = int((np.cumsum(cover)[:C] > 0).sum())
    out = min(int(pcnt.sum()), C)
    n_act = int(act.sum())
    read = (C + 4 * n_act + C + 4 * int(ev.sum())
            + int(feed.sum()) * (4 * (n - w) + 12 + 8 * m)
            + exits * (4 * w + 8))
    written = out * row_bytes(n, m) + C + 24
    ops = n_act * 2 * trips(C) + C + out * (trips(C) + 1)
    return read + written, ops


def splice_work(P, hit, plen, d0: int, d1: int, room=None) -> tuple:
    """(bytes, operations) one splice-only FOLD must spend on this input.
    Bytes: the hit flags, and the block length of every parent that hits;
    the block offset and the parent row (less the spliced columns) of
    every parent that fills an output row; one slab row of the spliced
    columns per output row; the output rows, the valid flags and the
    stats.  Operations: one scan of C values, and per output row the
    offset inversion.  ``room``: the output rows left to the splice (C
    unless a merged FOLD's replay rows come first)."""
    C, n = P.assign.shape
    m, w = P.lo.shape[1], d1 - d0 + 1
    room = C if room is None else room
    h = host(hit)
    scnt = np.where(h, host(plen), 0).astype(np.int64)
    soff = np.cumsum(scnt) - scnt
    feeding = int(((scnt > 0) & (soff < room)).sum())
    out = min(int(scnt.sum()), room)
    read = (C + 4 * int(h.sum())
            + feeding * (4 + 4 * (n - w) + 12 + 8 * m) + out * 4 * w)
    written = out * row_bytes(n, m) + C + 24
    ops = C + out * trips(C)
    return read + written, ops


def merged_work(P, active, ror, E, hit, plen, d0: int, d1: int) -> tuple:
    """(bytes, operations) one merged FOLD must spend on this input: its
    replay part (``fold_work``) and its splice part (``splice_work``,
    into the rows the replay leaves), with the valid flags and the stats
    written once."""
    C = P.assign.shape[0]
    rb, ro = fold_work(P, active, ror, E, d0, d1)
    ekey = np.where(host(E.valid), np.clip(host(E.orig), 0, C - 1), C)
    ecnt = np.bincount(ekey, minlength=C + 1)[:C]
    rep = np.clip(host(ror), 0, C - 1)
    n1 = min(int(np.where(host(active), ecnt[rep], 0).sum()), C)
    sb, so = splice_work(P, hit, plen, d0, d1, room=C - n1)
    return rb + sb - (C + 24), ro + so


def frontier_max_err(a, b, k: int) -> int:
    """Max |a - b| over the first k rows of every chunk field."""
    err = 0
    for f in ("assign", "factor", "orig", "lo", "hi"):
        x, y = getattr(a, f)[:k], getattr(b, f)[:k]
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def cycle_oracle(db, k: int) -> int:
    """Number of k-cycle matches (cq.cycle_query): the sum over edges
    (x1, xk) of (A^(k-1))[x1, xk], computed as sum(A^(k-2) ∘ (A Aᵀ))."""
    import scipy.sparse as sp
    e = db.relations["E"]
    nv = int(e.max()) + 1
    A = sp.csr_matrix((np.ones(len(e), np.int64), (e[:, 0], e[:, 1])),
                      shape=(nv, nv))
    P = A
    for _ in range(k - 3):
        P = P @ A
    return int(P.multiply(A @ A.T).sum())


def path_oracle(db, k: int) -> int:
    """Number of k-path matches (cq.path_query: k - 1 edges): the sum of
    the entries of A^(k-1)."""
    import scipy.sparse as sp
    e = db.relations["E"]
    nv = int(e.max()) + 1
    A = sp.csr_matrix((np.ones(len(e), np.int64), (e[:, 0], e[:, 1])),
                      shape=(nv, nv))
    P = A
    for _ in range(k - 2):
        P = P @ A
    return int(P.sum())


def grqc_db():
    """The ca-GrQc-scale graph (made anew in every process that needs it)."""
    return graph_db(zipf_graph(GRQC["nv"], GRQC["ne"], ZIPF_A, seed=SEED + 1),
                    symmetrize=True)


def renamed(q):
    """An isomorphic copy of ``q``: variables renamed, atoms reversed."""
    names = {v: f"w{i}" for i, v in enumerate(reversed(q.variables))}
    return CQ(tuple(reversed(rename_query(q, names).atoms)))


# ---------------------------------------------------------------------------
# Phase 3 inputs: seeded, at the main path's shapes
# ---------------------------------------------------------------------------


def expand_inputs(eng, d: int, rng, dev, cap: int = C):
    """A chunk of ``cap`` rows for EXPAND(d) of ``eng``: 3/4 of the rows
    valid, each guard window 0-2 runs of the guard level, each other
    atom's window one sibling run of its level (sorted, as the trie gives
    it)."""
    args = eng.expand_kernel_args(d)
    m, n = eng.m, eng.n
    lo = np.zeros((cap, m), np.int32)
    hi = np.tile(np.asarray(eng.sizes, np.int32), (cap, 1))
    parts = dict(eng.at_depth[d])
    for ai, lvl in parts.items():
        size = eng.sizes[ai]
        if ai == args["g_ai"]:
            rs = eng.levels[ai][lvl].runstarts_np
            ends = np.append(rs, size)
            r = rng.integers(0, len(rs), cap)
            w = rng.integers(0, 3, cap)
            lo[:, ai] = rs[r]
            hi[:, ai] = ends[np.minimum(r + w, len(rs))]
        elif lvl > 0:
            rs = eng.levels[ai][lvl - 1].runstarts_np
            ends = np.append(rs, size)
            r = rng.integers(0, len(rs), cap)
            lo[:, ai] = rs[r]
            hi[:, ai] = ends[r + 1]
    F = Frontier(
        assign=torch.from_numpy(rng.integers(0, 1 << 12, (cap, n))
                                .astype(np.int32)),
        factor=torch.from_numpy(rng.integers(1, 6, cap).astype(np.int64)),
        valid=torch.from_numpy(rng.random(cap) < 0.75),
        orig=torch.from_numpy(np.sort(rng.integers(0, cap, cap))
                              .astype(np.int32)),
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    F = Frontier(*(t.to(dev) for t in F))
    kw = dict(d=d, g_ai=args["g_ai"], other_ais=args["other_ais"],
              n_rows_g=args["n_rows_g"])
    return F, args["g_col"], args["g_rs"], args["other_cols"], kw


def fold_inputs(eng, rng, dev, cap: int = C):
    """Parent and sorted exit chunks of ``cap`` rows for the plan's first
    FOLD bracket."""
    op = next(o for o in eng.schedule.ops if o.kind == FOLD_CHILD)
    n, m, C = eng.n, eng.m, cap
    reps, n_exits = C // 4, C // 4

    def chunk(valid, orig):
        return Frontier(
            assign=torch.from_numpy(rng.integers(0, 1 << 12, (C, n))
                                    .astype(np.int32)),
            factor=torch.from_numpy(rng.integers(1, 6, C).astype(np.int64)),
            valid=torch.from_numpy(valid),
            orig=torch.from_numpy(orig.astype(np.int32)),
            lo=torch.from_numpy(rng.integers(0, 1 << 16, (C, m))
                                .astype(np.int32)),
            hi=torch.from_numpy(rng.integers(0, 1 << 16, (C, m))
                                .astype(np.int32)))

    ar = np.arange(C)
    P = chunk(ar < int(0.6 * C), ar)
    eorig = np.full(C, reps - 1)
    eorig[:n_exits] = np.sort(rng.integers(0, reps, n_exits))
    E = chunk(ar < n_exits, eorig)
    active = torch.from_numpy((ar < int(0.6 * C)) & (rng.random(C) < 0.8))
    ror = torch.from_numpy(rng.integers(0, reps, C).astype(np.int32))
    P = Frontier(*(t.to(dev) for t in P))
    E = Frontier(*(t.to(dev) for t in E))
    return P, active.to(dev), ror.to(dev), E, op.sub_first, op.sub_last


def merged_inputs(eng, rng, dev, plen_max: int, cap: int = C):
    """fold_inputs plus payload hits on the parents that do not replay
    (the executor's ``active = valid & ~hit``), each with a block of 1 to
    ``plen_max`` rows at a random offset of a 2^17-row slab."""
    P, active, ror, E, d0, d1 = fold_inputs(eng, rng, dev, cap)
    C = cap
    w = d1 - d0 + 1
    hit = P.valid & ~active
    plen = torch.from_numpy(rng.integers(1, plen_max + 1, C)
                            .astype(np.int32)).to(dev)
    plen = torch.where(hit, plen, 0)
    slab_rows = 1 << 17
    poff = torch.from_numpy(rng.integers(0, slab_rows - plen_max, C)
                            .astype(np.int32)).to(dev)
    poff = torch.where(hit, poff, 0)
    slab = torch.from_numpy(rng.integers(0, 1 << 12, (slab_rows + 1, w))
                            .astype(np.int32)).to(dev)
    return (P, active, ror, E, hit, poff, plen, slab), d0, d1


def merged_check(args, d0: int, d1: int, what: str) -> tuple:
    """The merged kernel against its plain version on ``args``: returns
    (max_abs_err, plain stats)."""
    (Oc, sc) = fold_cuda.merged(*args, d0=d0, d1=d1)
    (Op, sp_) = fold_plain.merged(*args, d0=d0, d1=d1)
    torch.cuda.synchronize()
    check(torch.equal(sc, sp_),
          f"{what}: merged stats {sc.tolist()} != {sp_.tolist()}")
    check(torch.equal(Oc.valid, Op.valid), f"{what}: merged valid differ")
    k = int(Op.valid.sum())
    err = frontier_max_err(Oc, Op, k)
    check(err == 0, f"{what}: merged differs on the valid prefix "
          f"(err {err})")
    return err, sp_.tolist()


def bound_inputs(eng, rng, dev):
    """C queries for the leapfrog bound on the largest trie level of
    ``eng`` (a column sorted within each run of its parent level), each
    window one whole run, each value drawn over the column's range."""
    ai = max(range(eng.m), key=lambda a: eng.sizes[a])
    col = eng.levels[ai][1].col
    rs = eng.levels[ai][0].runstarts_np
    ends = np.append(rs[1:], eng.sizes[ai])
    r = rng.integers(0, len(rs), C)
    v = rng.integers(-1, int(col.max()) + 2, C)

    def dev_i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    return col, dev_i32(v), dev_i32(rs[r]), dev_i32(ends[r])


def bit_lengths(a: np.ndarray) -> np.ndarray:
    """Bit length of each non-negative value (0 for 0)."""
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))) + 1, 0)


def bound_work(lo, hi, n: int) -> tuple:
    """(bytes, operations) one bound call must spend on these queries.
    Bytes: each query's value, lo and hi in and its result out, and one
    column value of every distinct non-empty window (a search reads at
    least one value inside its window; the windows here are disjoint
    runs).  Operations: the search steps, the bit length of each window's
    width."""
    start = np.maximum(host(lo).astype(np.int64), 0)
    end = np.minimum(host(hi).astype(np.int64), n)
    width = np.maximum(end - start, 0)
    keep = width > 0
    windows = np.unique(np.stack([start[keep], end[keep]]), axis=1).shape[1]
    return 16 * start.size + 4 * windows, int(bit_lengths(width).sum())


def atoms_work(cols, ais, ok, lo2, hi2, out) -> tuple:
    """(bytes, operations) one membership test must spend on these slots,
    given the plain version's outputs ``out`` = (ok, lo2, hi2).  A slot is
    searched in an atom while no earlier atom has rejected it (the
    leapfrog rule).  Bytes: every slot's ok flag in, and out where an
    atom rejects the slot; each live slot's value; each searched (slot,
    atom)'s window in; the narrowed windows out of each slot that every
    atom keeps (the only windows the chain reads); one column value of
    every distinct non-empty window searched.  Operations: the lower
    bound's search steps (the bit length of the window's width) and the
    upper bound's (the bit length of the run found, plus one)."""
    alive = host(ok).copy()
    kept = int(host(out[0]).sum())
    n_bytes = (alive.size + (int(alive.sum()) - kept) + 4 * int(alive.sum())
               + 8 * len(ais) * kept)
    ops, windows = 0, set()
    for col, ai in zip(cols, ais):
        idx = np.flatnonzero(alive)
        n = col.numel()
        start = np.maximum(host(lo2[idx, ai]).astype(np.int64), 0)
        end = np.minimum(host(hi2[idx, ai]).astype(np.int64), n)
        width = np.maximum(end - start, 0)
        s = host(out[1][idx, ai]).astype(np.int64)
        e = host(out[2][idx, ai]).astype(np.int64)
        keep = width > 0
        windows.update(zip([ai] * int(keep.sum()), start[keep], end[keep]))
        n_bytes += 8 * idx.size
        ops += int(bit_lengths(width).sum()
                   + np.where(keep, bit_lengths(e - s) + 1, 0).sum())
        alive[idx[s >= e]] = False
    return n_bytes + 4 * len(windows), ops


def atoms_inputs(eng, rng, dev):
    """The membership test of a chain EXPAND on a seeded chunk of C rows
    (expand_inputs at the depth with the most membership atoms), as the
    chain hands it over: (columns, atoms, values, ok, lo2, hi2), copied
    before the call."""
    F, g_col, g_rs, others, kw = expand_inputs(eng, expand_depth(eng), rng,
                                               dev)
    seen, call = [], expand_chain.bound_atoms

    def spy(cols, ais, values, ok, lo2, hi2, **how):
        seen.append((cols, ais) + tuple(t.clone() for t in
                                        (values, ok, lo2, hi2)))
        call(cols, ais, values, ok, lo2, hi2, **how)

    expand_chain.bound_atoms = spy
    try:
        expand_chain.expand_step(
            F, g_col, g_rs, others, impl="leapfrog",
            atoms=bound_cuda.Atoms(others, kw["other_ais"]), **kw)
    finally:
        expand_chain.bound_atoms = call
    return seen[0]


def atoms_check(cols, ais, values, ok, lo2, hi2, what: str) -> tuple:
    """``ctj_bound_atoms`` against ``plain.bound_atoms`` on copies of one
    membership test under their contract: ``ok`` equal on every slot, the
    windows equal on every slot whose final ``ok`` is set.  Returns
    (max_abs_err on those windows, the plain version's outputs)."""
    got = [t.clone() for t in (ok, lo2, hi2)]
    want = [t.clone() for t in (ok, lo2, hi2)]
    bound_cuda.bound_atoms(bound_cuda.Atoms(cols, ais), values, *got)
    bound_plain.bound_atoms(cols, ais, values, *want)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]),
          f"{what}: ok differs from the plain version's")
    keep = want[0]
    err = max((int((g[keep].long() - w[keep].long()).abs().max())
               if bool(keep.any()) else 0)
              for g, w in zip(got[1:], want[1:]))
    check(err == 0, f"{what}: windows differ on the kept slots (err {err})")
    return err, want


def bound_atoms_row(eng, rng, dev) -> dict:
    """Phase 3's membership-test row: ``ctj_bound_atoms`` on a seeded
    chain EXPAND of ``eng``'s plan against its plain version, its times
    (each timed call on fresh copies of the slots: the test narrows them
    in place) and its bound."""
    cols, ais, values, ok, lo2, hi2 = atoms_inputs(eng, rng, dev)
    err, want = atoms_check(cols, ais, values, ok, lo2, hi2, "bound_atoms")
    atoms = bound_cuda.Atoms(cols, ais)

    def on_fresh(call, k):
        pool = [[t.clone() for t in (ok, lo2, hi2)] for _ in range(k)]
        return lambda: call(*pool.pop())

    def kernel(*slots):
        bound_cuda.bound_atoms(atoms, values, *slots)

    def plain(*slots):
        bound_plain.bound_atoms(cols, ais, values, *slots)

    return dict(
        max_abs_err=err,
        ms=time_ms(on_fresh(kernel, 28)),
        **busy(on_fresh(kernel, 26)),
        plain_ms=time_ms(on_fresh(plain, 6), reps=5, warmup=1),
        **bound(*atoms_work(cols, ais, ok, lo2, hi2, want)),
        # no PyTorch call searches windows of shared columns
        # (torch.searchsorted takes one sorted row per query)
        library_ms=None,
        note=(f"C={ok.numel()} atoms={list(ais)} "
              f"N={[c.numel() for c in cols]} "
              f"live={int(ok.sum())} kept={int(want[0].sum())}; ok on "
              f"every slot and windows on the kept slots bit-exact"))


def cycle_engine(db, dev):
    """The 4-cycle's engine on ``db`` (the plan phase 3's inputs follow)
    and its variable order."""
    td, order = engine.plan_query(cycle_query(4), db)
    return CachedTrieJoin(cycle_query(4), td, order, db, capacity=C,
                          device=dev), order


def expand_depth(eng) -> int:
    """The depth whose EXPAND has the most membership atoms."""
    return max(reversed(range(eng.n)), key=lambda x: len(eng.at_depth[x]))


def expand_case(db, rng, dev, cap: int):
    """Phase 3's EXPAND input: the 4-cycle's engine on ``db``, its
    variable order, and a chunk of ``cap`` rows (expand_inputs) for its
    EXPAND at the depth with the most membership atoms."""
    eng, order = cycle_engine(db, dev)
    return eng, order, expand_inputs(eng, expand_depth(eng), rng, dev, cap)


def expand_row(inputs, plain_reps: int = 25) -> dict:
    """Phase 3's EXPAND row: the kernel bit for bit against its plain
    version on ``inputs``, its times and its bound."""
    F, g_col, g_rs, others, kw = inputs
    (Fc, nc) = expand_cuda.expand(F, g_col, g_rs, others, **kw)
    (Fp, np_) = expand_plain.expand_step(F, g_col, g_rs, others, **kw)
    torch.cuda.synchronize()
    cap = F.assign.shape[0]
    check(int(nc) == int(np_), f"expand at C={cap}: needed {int(nc)} != "
          f"{int(np_)}")
    check(torch.equal(Fc.valid, Fp.valid),
          f"expand at C={cap}: valid masks differ")
    k = int(Fp.valid.sum())
    err = frontier_max_err(Fc, Fp, k)
    check(err == 0, f"expand at C={cap} differs on the valid prefix (err "
          f"{err})")
    del Fc, Fp
    moved, ops = expand_work(F, g_col, g_rs, others, kw)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: expand_cuda.expand(F, g_col, g_rs, others, **kw)),
        **busy(lambda: expand_cuda.expand(F, g_col, g_rs, others, **kw)),
        plain_ms=time_ms(lambda: expand_plain.expand_step(
            F, g_col, g_rs, others, **kw), reps=plain_reps,
            warmup=min(3, plain_reps)),
        **bound(moved, ops), library_ms=None,
        note=f"C={cap} d={kw['d']} needed={int(np_)} survivors={k}")


def fold_row(P, active, ror, E, d0: int, d1: int,
             plain_reps: int = 25) -> dict:
    """Phase 3's FOLD replay row: the kernel bit for bit against its
    plain version, its times and its bound."""
    cap = P.assign.shape[0]
    (Oc, sc) = fold_cuda.replay(P, active, ror, E, d0=d0, d1=d1)
    (Op, sp_) = fold_plain.replay(P, active, ror, E, d0=d0, d1=d1)
    torch.cuda.synchronize()
    check(torch.equal(sc, sp_), f"fold at C={cap}: stats {sc.tolist()} != "
          f"{sp_.tolist()}")
    check(torch.equal(Oc.valid, Op.valid),
          f"fold at C={cap}: valid masks differ")
    k = int(Op.valid.sum())
    err = frontier_max_err(Oc, Op, k)
    check(err == 0, f"fold at C={cap} differs on the valid prefix (err "
          f"{err})")
    del Oc, Op
    moved, ops = fold_work(P, active, ror, E, d0, d1)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: fold_cuda.replay(P, active, ror, E, d0=d0,
                                            d1=d1)),
        **busy(lambda: fold_cuda.replay(P, active, ror, E, d0=d0, d1=d1)),
        plain_ms=time_ms(lambda: fold_plain.replay(P, active, ror, E,
                                                   d0=d0, d1=d1),
                         reps=plain_reps, warmup=min(3, plain_reps)),
        **bound(moved, ops), library_ms=None,
        note=f"C={cap} span=[{d0},{d1}] needed={int(sp_[0])}")


def emit_inputs(n: int, rng, dev, cap: int = C):
    """A chunk of ``cap`` rows of n columns for EMIT, half of them valid."""
    assign = torch.from_numpy(rng.integers(0, 1 << 12, (cap, n))
                              .astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(cap) < 0.5).to(dev)
    return assign, valid


def emit_row(assign, valid, plain_reps: int = 25) -> dict:
    """Phase 3's EMIT row: the kernel bit for bit against its plain
    version, its times, its bound and one PyTorch call's time."""
    cap, n = assign.shape
    (pc, kc) = emit_cuda.pack(assign, valid)
    (pp, kp) = emit_plain.pack(assign, valid)
    torch.cuda.synchronize()
    check(int(kc) == int(kp), f"emit at C={cap}: k {int(kc)} != {int(kp)}")
    k = int(kp)
    err = int((pc[:k].long() - pp[:k].long()).abs().max()) if k else 0
    check(err == 0, f"emit at C={cap} differs on the packed prefix (err "
          f"{err})")
    del pc, pp
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: emit_cuda.pack(assign, valid)),
        **busy(lambda: emit_cuda.pack(assign, valid)),
        plain_ms=time_ms(lambda: emit_plain.pack(assign, valid),
                         reps=plain_reps, warmup=min(3, plain_reps)),
        # the valid flags and the k valid rows in, the k rows and k out;
        # one scan of the valid flags
        **bound(cap + 2 * 4 * n * k + 4, cap),
        # one PyTorch call computing the same rows: a boolean-mask gather
        library_ms=time_ms(lambda: assign[valid]),
        note=f"C={cap} k={k}")


def merged_row(args, d0: int, d1: int, what: str,
               plain_reps: int = 25) -> dict:
    """A FOLD merged row: the kernel bit for bit against its plain
    version on ``args``, its times and its bound."""
    err, st = merged_check(args, d0, d1, what)
    P, active, ror, E, hit, poff, plen, slab = args
    moved, ops = merged_work(P, active, ror, E, hit, plen, d0, d1)
    return dict(
        max_abs_err=err, stats=st,
        ms=time_ms(lambda: fold_cuda.merged(*args, d0=d0, d1=d1)),
        **busy(lambda: fold_cuda.merged(*args, d0=d0, d1=d1)),
        plain_ms=time_ms(lambda: fold_plain.merged(*args, d0=d0, d1=d1),
                         reps=plain_reps, warmup=min(3, plain_reps)),
        **bound(moved, ops), library_ms=None,
        note=(f"C={P.assign.shape[0]} span=[{d0},{d1}] needed={st[0]} "
              f"n_spliced={st[1]} hits={int(hit.sum())}"))


# the kernels phase 3 also holds at the static pass's capacity, each on
# its own seeded inputs (scripts/kernel_ab.py draws the same ones;
# EXPAND's seed is the one its 2^25 row had before the others joined)
STATIC_SCALE = ("expand", "fold_replay", "fold_merged", "emit")


def kernel_inputs(name: str, eng, dev, cap: int):
    """Seeded inputs of ``cap`` rows for kernel ``name`` on ``eng``'s
    plan: EXPAND's chunk at the depth with the most membership atoms,
    FOLD replay's parents and sorted exits, FOLD merged's with payload
    hits of up to 16 rows (more rows than the chunk holds), EMIT's chunk
    of eng.n columns."""
    if name == "expand":
        rng = np.random.default_rng([SEED, cap])
        return expand_inputs(eng, expand_depth(eng), rng, dev, cap)
    rng = np.random.default_rng([SEED, cap, STATIC_SCALE.index(name)])
    if name == "fold_replay":
        return fold_inputs(eng, rng, dev, cap)
    if name == "fold_merged":
        return merged_inputs(eng, rng, dev, 16, cap)
    return emit_inputs(eng.n, rng, dev, cap)


def kernel_row(name: str, inputs, plain_reps: int = 3) -> dict:
    """``name``'s row on ``kernel_inputs``: bit for bit against its plain
    version, its times and its bound (the plain version timed over
    ``plain_reps`` calls: at 2^25 rows it takes hundreds of ms), with its
    device busy time split by device op in the note."""
    if name == "expand":
        row = expand_row(inputs, plain_reps=plain_reps)
    elif name == "fold_replay":
        row = fold_row(*inputs, plain_reps=plain_reps)
    elif name == "fold_merged":
        args, d0, d1 = inputs
        row = merged_row(args, d0, d1, f"merged at C="
                         f"{args[0].assign.shape[0]}", plain_reps)
    else:
        row = emit_row(*inputs, plain_reps=plain_reps)
    row["note"] += "; busy by op: " + ", ".join(
        f"{k.split('(')[0].replace('void ', '').strip()} {v:.4f} ms"
        for k, v in sorted(row["busy_ops"].items(), key=lambda kv: -kv[1]))
    return row


def kernels_vs_plain(db, dev):
    """Phase 3: each kernel against its plain version at C = 2^16 (FOLD
    merged also on seeded inputs, returned apart: the kernels line keeps
    one row a kernel)."""
    rng = np.random.default_rng(SEED)
    eng, order, inputs = expand_case(db, rng, dev, C)
    rows = {"expand": expand_row(inputs)}
    seeded = {}

    # FOLD, replay-only
    rows["fold_replay"] = fold_row(*fold_inputs(eng, rng, dev))

    # FOLD, merged: seeded inputs that replay and splice, one of them with
    # more rows than the chunk holds (its row comes from the static pass)
    for label, plen_max in (("fits", 4), ("truncated", 16)):
        args, d0, d1 = merged_inputs(eng, rng, dev, plen_max)
        err, st = merged_check(args, d0, d1, f"merged {label}")
        check((st[0] + st[1] > C) == (label == "truncated"),
              f"merged {label}: stats {st} do not fit the case")
        seeded[label] = dict(
            err=err, stats=st,
            ms=time_ms(lambda: fold_cuda.merged(*args, d0=d0, d1=d1)),
            plain_ms=time_ms(lambda: fold_plain.merged(*args, d0=d0,
                                                       d1=d1)))

    # EMIT
    rows["emit"] = emit_row(*emit_inputs(eng.n, rng, dev))

    # the leapfrog bound: C queries, each window a run of a trie level
    col, v, lo, hi = bound_inputs(eng, rng, dev)
    err = 0
    for strict in (True, False):
        bc = bound_cuda.bound(col, v, lo, hi, strict=strict)
        bp = bound_plain.bound(col, v, lo, hi, strict=strict)
        torch.cuda.synchronize()
        err = max(err, int((bc.long() - bp.long()).abs().max()))
    check(err == 0, f"bound differs from its plain version (err {err})")
    rows["bound"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: bound_cuda.bound(col, v, lo, hi, strict=True)),
        **busy(lambda: bound_cuda.bound(col, v, lo, hi, strict=True)),
        plain_ms=time_ms(lambda: bound_plain.bound(col, v, lo, hi,
                                                   strict=True)),
        **bound(*bound_work(lo, hi, col.numel())),
        # no PyTorch call searches a window of a shared column
        # (torch.searchsorted takes one sorted row per query)
        library_ms=None,
        note=f"M={C} N={col.numel()} strict and non-strict bit-exact")

    # the chain EXPAND's membership test: every atom's bounds, one launch
    rows["bound_atoms"] = bound_atoms_row(eng, rng, dev)

    return rows, dict(n=eng.n, m=eng.m, order=order), seeded


def static_scale_rows(db2, dev) -> dict:
    """Phase 3 at the static pass's capacity: EXPAND, FOLD replay, FOLD
    merged and EMIT at C = 2^25 on the ca-GrQc-scale graph's plan, one at
    a time (each chunk is GBs)."""
    eng, _ = cycle_engine(db2, dev)
    big = {}
    for name in STATIC_SCALE:
        inputs = kernel_inputs(name, eng, dev, C_STATIC)
        big[name] = kernel_row(name, inputs)
        del inputs
        gc.collect()
        torch.cuda.empty_cache()
    return big


# the tier-2 ops at the static benchmark cell's shapes
# (graph500.static-cycle4-count): C = 2^26 rows, a 4-cycle pass's 1,410,739
# representatives offered for insert and its 6,236,814 valid rows probed,
# each a prefix of the chunk, 2^19 sets x 8 ways
TIER2 = dict(C=1 << 26, sets=1 << 19, ways=8, live=1_410_739,
             probed=6_236_814)
# (policy, payload planes, prefilled table): the cell's fresh setassoc
# tables first (its calls are the timed ones), then a prefilled costaware
# table and a prefilled payload table
TIER2_CASES = (("setassoc", False, False), ("costaware", False, True),
               ("setassoc", True, True))


def tier2_inputs(case: int, dev):
    """Seeded inputs of TIER2_CASES[case] on the card: the table planes
    (with the payload planes), the chunk's keys, values, costs and live
    prefix, the payload rows, and the probe's keys (half the chunk's keys,
    half misses) and valid prefix.  A prefilled table is 90% used, and a
    third of the live keys sit in their own sets, so rows are blocked,
    refreshed, refused and evicted."""
    policy, pay, prefilled = TIER2_CASES[case]
    C, S, W, live = TIER2["C"], TIER2["sets"], TIER2["ways"], TIER2["live"]
    g = torch.Generator(device=dev).manual_seed(SEED * 100 + case)

    def draw(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    rows = torch.arange(C, device=dev)
    keys = draw(0, 1 << 40, (C,))
    chunk = (keys, draw(0, 1000, (C,)), draw(1, 100, (C,)), rows < live)
    table = [draw(0, 1 << 40, (S, W)), draw(0, 1000, (S, W)),
             torch.zeros((S, W), dtype=torch.bool, device=dev),
             torch.zeros((S, W), dtype=torch.int32, device=dev),
             torch.zeros((S, W), dtype=torch.int64, device=dev)]
    if prefilled:
        table[2] = torch.rand((S, W), generator=g, device=dev) < 0.9
        table[3] = draw(0, 6, (S, W), torch.int32)
        table[4] = draw(1, 100, (S, W))
        resident = keys[:live:3]
        sets = tier2_plain.hash_sets(resident, S)
        ways = draw(0, W, resident.shape)
        table[0][sets, ways] = resident
        table[2][sets, ways] = True
    pays = None
    if pay:
        pays = (draw(0, 1 << 12, (S, W), torch.int32),
                draw(-1, 6, (S, W), torch.int32),
                draw(0, 1 << 12, (C,), torch.int32),
                draw(-1, 6, (C,), torch.int32))
    qkeys = torch.where(torch.rand(C, generator=g, device=dev) < 0.5, keys,
                        keys + 1)
    return (policy, table, chunk, pays,
            (qkeys, rows < TIER2["probed"]))


def tier2_same(got, want, what: str) -> None:
    """Every output of a tier-2 kernel equals its plain twin's exactly."""
    check(len(got) == len(want), f"{what}: {len(got)} outputs, plain "
          f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{what}: output {i} differs from the plain twin's")


def tier2_rows(dev) -> dict:
    """Phase 3, tier 2: ``cache._insert``, then ``_probe`` (and with
    payloads ``_probe_payload``) on the table it made, through the kernels
    of ``csrc/tier2.cu`` at the static cell's shapes, each output held
    exactly against the plain twin's on the same card tensors (every table
    plane, the stamps, the admit and evict counts, the hits and values);
    the wrapper's launches counted (two a round, one a probe).  The fresh
    setassoc case is timed: the rows of ``tier2_insert`` and
    ``tier2_probe``."""
    C, S, W = TIER2["C"], TIER2["sets"], TIER2["ways"]
    rounds = min(W, 8)
    out, seen = {}, []
    for case in range(len(TIER2_CASES)):
        policy, table, chunk, pays, probe_rows = tier2_inputs(case, dev)
        what = f"tier2 {policy}{' payload' if pays else ''} case {case}"
        launched = (tier2_cuda.insert_launches, tier2_cuda.probe_launches)
        ins = (lambda: cache_mod._insert(*table, *chunk, 3, policy=policy,
                                         rounds=rounds, pay=pays))
        got = ins()
        want = tier2_plain.insert(*table, *chunk, 3, policy=policy,
                                  rounds=rounds, pay=pays)
        tier2_same(got, want, f"{what} insert")
        n_admit, n_evict = int(want[-2]), int(want[-1])
        check(n_admit > 0 and (n_evict > 0) == (case > 0),
              f"{what}: {n_admit} admits, {n_evict} evictions")
        tk, tv, tu, ts = got[:4]
        probe = (lambda: cache_mod._probe(tk, tv, tu, ts, *probe_rows, 4))
        gp = probe()
        wp = tier2_plain.probe(tk, tv, tu, ts, *probe_rows, 4)
        n_probes = 1
        if pays:
            tpoff, tplen = got[5:7]
            gp += cache_mod._probe_payload(tk, tu, ts, tpoff, tplen,
                                           *probe_rows, 5)
            wp += tier2_plain.probe_payload(tk, tu, ts, tpoff, tplen,
                                            *probe_rows, 5)
            n_probes = 2
        tier2_same(gp, wp, f"{what} probe")
        n_hits = int(wp[0].sum())
        check(n_hits > 0, f"{what}: the probe hit nothing")
        check((tier2_cuda.insert_launches - launched[0],
               tier2_cuda.probe_launches - launched[1])
              == (2 * rounds, n_probes),
              f"{what}: wrapper launches {tier2_cuda.insert_launches} / "
              f"{tier2_cuda.probe_launches} do not follow the calls")
        seen.append(f"{policy}{'+payload' if pays else ''}"
                    f"{' prefilled' if case else ' fresh'}: "
                    f"{n_admit} admitted, {n_evict} evicted, {n_hits} hits")
        if case == 0:
            tbytes = sum(t.numel() * t.element_size() for t in table)
            live, probed = TIER2["live"], TIER2["probed"]
            # insert: the mask, the live rows' keys, values and costs, the
            # table read and written once; probe: the mask, the valid
            # keys, the used plane, the stamp copy, C-wide hit and values
            work = {"tier2_insert": (ins, lambda: tier2_plain.insert(
                        *table, *chunk, 3, policy=policy, rounds=rounds),
                        C + 24 * live + 2 * tbytes),
                    "tier2_probe": (probe, lambda: tier2_plain.probe(
                        tk, tv, tu, ts, *probe_rows, 4),
                        C + 8 * probed + S * W + 8 * S * W + 9 * C)}
            for name, (fn, plain_fn, n_bytes) in work.items():
                row = dict(max_abs_err=0, ms=time_ms(fn), **busy(fn),
                           plain_ms=time_ms(plain_fn, reps=3, warmup=1),
                           **bound(n_bytes, 0), library_ms=None)
                row["note"] = (
                    f"C={C} S={S} W={W} live={live} probed={probed}; "
                    "busy by op: " + ", ".join(
                        f"{k.split('(')[0].replace('void ', '').strip()} "
                        f"{v:.4f} ms" for k, v in sorted(
                            row["busy_ops"].items(), key=lambda kv: -kv[1])))
                out[name] = row
        del table, chunk, pays, probe_rows, got, want, gp, wp, tk, tv, tu, ts
        gc.collect()
        torch.cuda.empty_cache()
    for row in out.values():
        row["note"] += "; exact on " + "; ".join(seen)
    return out


class SpliceCapture:
    """Record the splice kernel's largest call (most spliced rows) while
    a pass runs: its parent chunk, hit mask, block pointers and a copy of
    the node's slab as they were at the call (later stores write the slab
    in place).  Every call still launches the kernel."""

    def __init__(self):
        self.best = None
        self.n_spl = -1
        self._orig = fold_cuda.splice

    def __enter__(self):
        def spy(P, hit, poff, plen, slab, *, d0, d1):
            n_spl = int(torch.where(hit, plen, 0).sum())
            if n_spl > self.n_spl:
                self.n_spl = n_spl
                self.best = (P, hit, poff, plen, slab.clone(), d0, d1)
            return self._orig(P, hit, poff, plen, slab, d0=d0, d1=d1)

        fold_cuda.splice = spy
        return self

    def __exit__(self, *exc):
        fold_cuda.splice = self._orig
        return False


class MergedCapture:
    """Record the merged kernel's largest call (most replay and splice
    rows together) while a pass runs, with a copy of the slab as it was
    at the call (the store after it writes the slab in place).  Every
    call still launches the kernel."""

    def __init__(self):
        self.best = None
        self.rows = -1
        self._orig = fold_cuda.merged

    def __enter__(self):
        def spy(P, active, ror, E, hit, poff, plen, slab, *, d0, d1):
            out = self._orig(P, active, ror, E, hit, poff, plen, slab,
                             d0=d0, d1=d1)
            rows = int(out[1][0] + out[1][1])
            if rows > self.rows:
                self.rows = rows
                self.best = ((P, active, ror, E, hit, poff, plen,
                              slab.clone()), d0, d1)
            return out

        fold_cuda.merged = spy
        return self

    def __exit__(self, *exc):
        fold_cuda.merged = self._orig
        return False


def merged_vs_plain(capture: MergedCapture) -> dict:
    """Phase 3, fold_merged: the kernel against its plain version on the
    captured static-pass inputs (C = C_STATIC)."""
    args, d0, d1 = capture.best
    return merged_row(args, d0, d1, "merged (static pass)")


def splice_vs_plain(capture: SpliceCapture) -> dict:
    """Phase 3, fold_splice: the kernel against its plain version on the
    captured warm-pass inputs (C = 2^16)."""
    P, hit, poff, plen, slab, d0, d1 = capture.best
    (Oc, sc) = fold_cuda.splice(P, hit, poff, plen, slab, d0=d0, d1=d1)
    (Op, sp_) = fold_plain.splice(P, hit, poff, plen, slab, d0=d0, d1=d1)
    torch.cuda.synchronize()
    check(torch.equal(sc, sp_),
          f"splice stats {sc.tolist()} != {sp_.tolist()}")
    check(torch.equal(Oc.valid, Op.valid), "splice valid masks differ")
    k = int(Op.valid.sum())
    err = frontier_max_err(Oc, Op, k)
    check(err == 0, f"splice differs on the valid prefix (err {err})")
    moved, ops = splice_work(P, hit, plen, d0, d1)
    plens = host(plen)[host(hit)]
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: fold_cuda.splice(P, hit, poff, plen, slab,
                                            d0=d0, d1=d1)),
        **busy(lambda: fold_cuda.splice(P, hit, poff, plen, slab, d0=d0,
                                        d1=d1)),
        plain_ms=time_ms(lambda: fold_plain.splice(P, hit, poff, plen, slab,
                                                   d0=d0, d1=d1)),
        **bound(moved, ops), library_ms=None,
        note=(f"span=[{d0},{d1}] hits={plens.size} n_spliced="
              f"{int(sp_[1])} plen mean {plens.mean():.2f} max "
              f"{plens.max()}"))


def check_rows(rows, order, q, db, want: int, what: str) -> None:
    """Evaluated rows: the oracle's number of rows, unique, and every
    atom holds on every row."""
    n = len(order)
    check(rows.shape == (want, n), f"{what} rows {rows.shape} != "
          f"({want}, {n}) from the scipy oracle")
    edges = db.relations["E"]
    nv = int(edges.max()) + 1
    keys = np.ravel_multi_index(rows.T.astype(np.int64), (nv,) * n)
    check(np.unique(keys).size == keys.size, f"{what} rows not unique")
    ekeys = np.sort(edges[:, 0] * nv + edges[:, 1])
    pos = {x: i for i, x in enumerate(order)}
    for atom in q.atoms:
        u, v = (rows[:, pos[x]].astype(np.int64) for x in atom.vars)
        k = u * nv + v
        hit = np.searchsorted(ekeys, k)
        ok = (hit < ekeys.size) & (ekeys[np.minimum(hit, ekeys.size - 1)]
                                   == k)
        check(bool(ok.all()), f"{what} rows violate atom {atom}")


def profile_line(run, cross_check: bool = False) -> str:
    """Run ``run()`` once under torch.profiler: wall time, device busy
    time and share, and the device ops (kernels, copies) that took the
    most time; fails if a single-block scan (``block_scan``) ran.  Only
    device activity is traced: each device op is then counted once.
    With ``cross_check`` the ops (``device_ops``) must equal
    ``key_averages()``'s, each op's records and its time to 1 us a
    record."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops = [(k, secs, n) for k, (secs, n) in device_ops(prof).items()]
    summed = time.perf_counter() - t0
    if cross_check:
        slow = {e.key: (e.self_device_time_total / 1e6, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0}
        check(slow.keys() == {k for k, _, _ in ops} and all(
            slow[k][1] == n and abs(slow[k][0] - secs) <= 1e-6 * n
            for k, secs, n in ops),
            f"the raw trace's device ops differ from key_averages(): "
            f"{sorted(ops)[:8]} vs {sorted(slow.items())[:8]}")
    scans = [k for k, _, _ in ops if "block_scan" in k]
    check(not scans, f"a single-block scan ran on the traced path: {scans}")
    busy = sum(s for _, s, _ in ops)
    if not ops:
        return f"wall {wall:.3f} s (traced); device time not measured"
    ops.sort(key=lambda x: -x[1])
    top = ", ".join(f"{k[:48]} {s:.3f} s x{n}" for k, s, n in ops[:8])
    return (f"wall {wall:.3f} s (traced), device busy {busy:.3f} s = "
            f"{100 * busy / wall:.1f}% (idle {100 - 100 * busy / wall:.1f}%)"
            f"; top device ops: {top}; summarised in {summed:.1f} s")


def reset_launches() -> None:
    for mod, attr in WRAPPERS.values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in WRAPPERS.items()}


def digest(rows: np.ndarray) -> tuple:
    """Rows in order, as a shape and a hash of their bytes."""
    rows = np.ascontiguousarray(rows)
    return rows.shape, hashlib.sha1(rows.tobytes()).hexdigest()


def timed_pass(eng):
    """One evaluate pass of ``eng``: (rows, seconds), the clock stopped
    after the rows reached the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = list(eng.evaluate())
    secs = time.perf_counter() - t0
    return np.concatenate(blocks), secs


PAY_KEYS = ("tier2_replay_hits", "tier2_payload_flushes",
            "tier2_payload_throttled", "tier2_payload_skips",
            "tier2_slab_rows", "tier2_probes", "tier2_inserts")


def host_synced(fn):
    """Run ``fn()`` and return (result, seconds), the clock stopped after
    the results reached the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def static_phase(q, db, db2, want2: int, dev) -> dict:
    """Phase 10: the static executor on one card.  A count at ca-GrQc
    scale (the oracle's count, no overflow); a count at wiki-Vote scale at
    C_STATIC_WIKI, which must flag its overflow; an evaluation cold then
    warm at ca-GrQc scale with PAYLOAD_CACHE (the oracle's rows both
    passes, one host fetch each, warm replay hits)."""
    td, order = engine.plan_query(q, db)
    td2, order2 = engine.plan_query(q, db2)
    reset_launches()
    sc_ = StaticCLFTJ(q, td2, order2, db2, capacity=C_STATIC, device=dev)
    (total, ov), count_s = host_synced(
        lambda: [x.item() for x in sc_.count_fn()(sc_.initial_frontier())])
    count_needed = int(sc_.last_needed_max)
    check(total == want2 and not ov, f"static count {total} (overflow "
          f"{ov}) != scipy oracle {want2}")
    sw = StaticCLFTJ(q, td, order, db, capacity=C_STATIC_WIKI, device=dev)
    (wtotal, wov), wiki_s = host_synced(
        lambda: [x.item() for x in sw.count_fn()(sw.initial_frontier())])
    wiki_needed = int(sw.last_needed_max)
    check(wov and wiki_needed > C_STATIC_WIKI,
          f"wiki-scale static count at C={C_STATIC_WIKI}: overflow {wov} "
          f"with a largest need of {wiki_needed}")
    se = StaticCLFTJ(q, td2, order2, db2, capacity=C_STATIC,
                     cache=PAYLOAD_CACHE, device=dev)
    torch.cuda.reset_peak_memory_stats()
    tables, passes, digests = None, [], []
    for label in ("cold", "warm"):
        with SyncCounter() as sync:
            (rows_, stats_, tables), secs = host_synced(
                lambda: se.evaluate_static(tables))
        check_rows(rows_, order2, q, db2, want2, f"static {label}")
        check(stats_["count"] == want2 and not stats_["overflow"],
              f"static {label}: {stats_}")
        check(sync.count == 1 and sync.label_counts == {"static-eval": 1},
              f"static {label} fetched {dict(sync.label_counts)}")
        passes.append((label, secs, stats_, int(se.last_needed_max)))
        digests.append(digest(rows_))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_launches()
    check(passes[1][2]["tier2_replay_hits"] > 0,
          "the warm static pass served no replay hits")
    engines = (sc_, sw, se)
    for op in ("expand", "fold", "fold_merged", "emit"):
        check(all(e.stats[f"{op}_calls_torch"] == 0 for e in engines),
              f"a static pass ran {op} off the card")
    check(launches["fold_merged"] == se.stats["fold_merged_calls_cuda"] > 0,
          f"merged launches {launches['fold_merged']} != executor count "
          f"{se.stats['fold_merged_calls_cuda']}")
    check(launches["expand"] == sum(e.stats["expand_calls_cuda"]
                                    for e in engines)
          and launches["emit"] == se.stats["emit_calls_cuda"]
          and launches["fold_replay"] == se.stats["fold_calls_cuda"]
          - se.stats["fold_merged_calls_cuda"],
          "wrapper launches != executor counts in the static passes")
    check(all(e.stats[f"tier2_{op}_calls_torch"] == 0 for e in engines
              for op in ("probe", "insert")),
          "a static pass ran a tier-2 op off the card")
    probes = sum(e.stats["tier2_probe_calls_cuda"] for e in engines)
    # an insert call launches two kernels a round
    inserts = sum(2 * min(e.cache_config.ways, 8)
                  * e.stats["tier2_insert_calls_cuda"] for e in engines)
    check(launches["tier2_probe"] == probes > 0
          and launches["tier2_insert"] == inserts > 0,
          f"tier-2 launches {launches['tier2_probe']} / "
          f"{launches['tier2_insert']} != executor counts {probes} / "
          f"{inserts} in the static passes")
    print(f"[10 static] StaticCLFTJ, 4-cycle: count at ca-GrQc scale "
          f"C={C_STATIC}: {total} (oracle), largest need {count_needed}, "
          f"{count_s:.3f} s; count at wiki-Vote scale C={C_STATIC_WIKI}: "
          f"overflow flagged, largest need {wiki_needed}, {wiki_s:.3f} s; "
          f"evaluate at ca-GrQc scale C={C_STATIC}, cache setassoc 8-way "
          f"2^14 slots, payload_rows 2^17: rows={want2} (oracle) both "
          f"passes, unique, every atom holds, one static-eval fetch each; "
          + "; ".join(f"{lb} exec_s={secs:.3f} largest need {need} "
                      + json.dumps(st) for lb, secs, st, need in passes)
          + f"; sort-routed folds {se.stats['fold_sorted_exits']}; peak "
          f"device memory {peak_gb:.2f} GiB | launches "
          + json.dumps(launches), flush=True)
    return dict(count=total, launches=launches, engine=se, tables=tables,
                digests=digests, stats=[st for _, _, st, _ in passes],
                peak_gib=peak_gb)


def dist_worker(rank: int, world: int, work: str) -> int:
    """One rank of phase 11 (``chip_smoke.py --dist-worker RANK WORLD
    DIR``): the distributed count and evaluation (cold, then warm from
    its own tables) of the 4-cycle at ca-GrQc scale on a gloo group of
    ``world`` ranks on card 0.  Writes what it saw to DIR/rank<R>.json
    (and rank 0 the merged rows to DIR/rows.npz)."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    out = Path(work)
    dist.init_process_group("gloo", init_method=f"file://{out / 'init'}",
                            rank=rank, world_size=world)
    db2 = grqc_db()
    q = cycle_query(4)
    td2, order2 = engine.plan_query(q, db2)
    reset_launches()
    fn, eng = make_distributed_count(q, td2, order2, db2,
                                     capacity=C_STATIC, **DIST_KNOBS)
    (total, ov), count_s = host_synced(lambda: [x.item() for x in fn()])
    local, local_ov = (x.item() for x in eng.count_fn()(
        shard_frontier(eng, rank, world)))
    run, eng2 = make_distributed_evaluate(q, td2, order2, db2,
                                          capacity=C_STATIC, **DIST_KNOBS)
    (rows1, s1, tables), t1 = host_synced(run)
    (rows2, s2, _), t2 = host_synced(lambda: run(tables))
    res = dict(rank=rank, count=total, overflow=ov, local=local,
               local_overflow=local_ov, count_s=count_s, s1=s1, s2=s2,
               exec_s=[t1, t2],
               digest=[hashlib.sha1(r.tobytes()).hexdigest()
                       for r in (rows1, rows2)],
               stats={k: v for k, v in eng2.stats.items() if "calls" in k},
               launches=read_launches(),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if rank == 0:
        np.savez(out / "rows.npz", rows1=rows1, rows2=rows2)
    dist.barrier()
    dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def dist_phase(q, db2, want2: int, static_count: int) -> None:
    """Phase 11: the distributed count and evaluation in DIST_WORLD
    processes on the one card.  Every worker must exit 0; the count and
    the rows of both passes equal the oracle's, every rank gathered the
    same rows, the per-shard counts add up to phase 10's count and the
    warm pass serves replay hits."""
    work = ROOT / "build" / f"chip_smoke_dist_{int(time.time() * 1e3)}"
    work.mkdir(parents=True)
    procs = []
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker",
             str(r), str(DIST_WORLD), str(work)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DIST_WORLD)]
        outs = [p.communicate(timeout=DIST_TIMEOUT_S)[0] for p in procs]
        wall = time.perf_counter() - t0
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0,
                  f"distributed rank {r} exited {p.returncode}:\n{o[-4000:]}")
        res = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(DIST_WORLD)]
        saved = np.load(work / "rows.npz")
        for key in ("rows1", "rows2"):
            check_rows(saved[key], engine.plan_query(q, db2)[1], q, db2,
                       want2, f"distributed {key}")
    finally:
        for p in procs:
            p.kill()
            p.wait()
        shutil.rmtree(work, ignore_errors=True)
    for r in res:
        check(r["count"] == want2 and r["overflow"] == 0,
              f"rank {r['rank']}: distributed count {r['count']} "
              f"(overflow {r['overflow']}) != oracle {want2}")
        for s_ in (r["s1"], r["s2"]):
            check(s_["count"] == want2 and not s_["overflow"],
                  f"rank {r['rank']}: distributed evaluation {s_}")
        check(r["digest"] == res[0]["digest"],
              f"rank {r['rank']} gathered other rows than rank 0")
        check(all(v == 0 for k, v in r["stats"].items() if "torch" in k),
              f"rank {r['rank']} ran a kernel off the card")
        check(r["launches"]["fold_merged"]
              == r["stats"]["fold_merged_calls_cuda"] > 0,
              f"rank {r['rank']}: merged launches != executor count")
    local = [r["local"] for r in res]
    check(sum(local) == static_count,
          f"per-shard counts {local} do not add up to {static_count}")
    check(res[0]["s2"]["tier2_replay_hits"] > 0,
          "the warm distributed pass served no replay hits")
    print(f"[11 distributed] {DIST_WORLD} processes on one card, gloo, "
          f"4-cycle at ca-GrQc scale, C={C_STATIC}, default cache (direct "
          f"2^15 slots, payloads), knobs {DIST_KNOBS}: count {res[0]['count']} (oracle) = sum "
          f"of shards {local} = static count; rows={want2} (oracle) cold "
          f"and warm, the same on every rank; cold {res[0]['s1']}, warm "
          f"{res[0]['s2']}; per rank count_s / exec_s cold, warm: "
          + ", ".join(f"{r['count_s']:.3f}/{r['exec_s'][0]:.3f}/"
                      f"{r['exec_s'][1]:.3f}" for r in res)
          + "; peak GiB " + ", ".join(f"{r['peak_gib']:.2f}" for r in res)
          + f"; wall {wall:.1f} s with process start", flush=True)


class BoundCapture:
    """Record the membership test of one real chain EXPAND while a run
    goes on: of the first ``TRIES`` chain EXPANDs with a membership atom,
    the one with the most candidate slots (``needed``, fetched for these
    calls only), its inputs copied before the call.  Every call still
    launches the kernel."""

    TRIES = 64

    def __init__(self):
        self.call, self.needed, self.tries = None, -1, 0
        self._step = expand_chain.expand_step
        self._atoms = bound_cuda.bound_atoms

    def __enter__(self):
        calls = []

        def atoms_spy(atoms, values, ok, lo2, hi2):
            if self.tries < self.TRIES:
                calls.append(tuple(t.clone() for t in
                                   (values, ok, lo2, hi2)))
            return self._atoms(atoms, values, ok, lo2, hi2)

        def step_spy(F, g_col, g_rs, other_cols, **kw):
            calls.clear()
            out = self._step(F, g_col, g_rs, other_cols, **kw)
            if other_cols and self.tries < self.TRIES:
                self.tries += 1
                needed = int(out[1])
                if needed > self.needed:
                    self.needed = needed
                    self.call = (other_cols, kw["other_ais"]) + calls[0]
            return out

        expand_chain.expand_step = step_spy
        bound_cuda.bound_atoms = atoms_spy
        return self

    def __exit__(self, *exc):
        expand_chain.expand_step = self._step
        bound_cuda.bound_atoms = self._atoms
        return False

    def check(self) -> str:
        """The kernel against its plain version on the captured call,
        under their contract; the widths of the windows it searched (each
        live slot's, each atom's) and the lengths of the runs it found
        (each kept slot's, each atom's)."""
        check(self.call is not None, "the capture saw no membership test")
        cols, ais, values, ok, lo2, hi2 = self.call
        _, (kept, lo_out, hi_out) = atoms_check(
            cols, ais, values, ok, lo2, hi2,
            "a chain EXPAND's membership test")
        live, kept = host(ok), host(kept)
        widths = np.concatenate([
            np.maximum(np.minimum(host(hi2[:, ai]), c.numel())
                       - np.maximum(host(lo2[:, ai]), 0), 0)[live]
            for c, ai in zip(cols, ais)])
        runs = np.concatenate([host(hi_out[:, ai] - lo_out[:, ai])[kept]
                               for ai in ais])

        def spread(a):
            if not a.size:
                return "none"
            p50, p99 = np.percentile(a, [50, 99])
            return f"median {p50:g}, p99 {p99:g}, max {int(a.max())}"

        return (f"a chain EXPAND with needed={self.needed}, atoms "
                f"{list(ais)} (N={[c.numel() for c in cols]}), "
                f"{int(live.sum())} live slots, {int(kept.sum())} kept: "
                f"bit-exact under the contract; window widths "
                f"{spread(widths)}; runs found {spread(runs)}")


def leapfrog_phase(q, db, db2, want: int, want2: int, fused_rows,
                   dev) -> dict:
    """Phase 12: the chain EXPAND with the leapfrog membership kernel.  A
    count at wiki-Vote scale and an evaluation at ca-GrQc scale, each
    equal to the scipy oracle and to the fused path (the evaluation row
    for row); each run's ``bound_calls_cuda`` equals the
    ``ctj_bound_atoms`` launches, one a chain EXPAND (the 4-cycle has one
    membership atom at every depth, whose two bounds are one launch), no
    bound call ran off the card, no ``ctj_bound`` and no fused EXPAND
    ran.  Then the reference's public bounded search,
    ``registry.lower_bound`` / ``upper_bound`` with ``impl="leapfrog"``
    on a CUDA column (``ctj_bound``), against ``impl="bsearch"``."""
    reset_launches()
    with BoundCapture() as cap:
        res = engine.count(q, db, capacity=C, **CHAIN)
    after_count = read_launches()
    check(res.count == want, f"chain count {res.count} != oracle {want}")
    res2 = engine.evaluate(q, db2, capacity=C, **CHAIN)
    launches = read_launches()
    check_rows(res2.tuples, res2.order, q, db2, want2, "chain evaluate")
    check(np.array_equal(res2.tuples, fused_rows),
          "chain evaluate rows differ from the fused path's")
    runs = ((res, after_count),
            (res2, {k: launches[k] - after_count[k] for k in launches}))
    for r, lau in runs:
        c = r.counters
        check(c["bound_calls_cuda"] > 0 and c["bound_calls_torch"] == 0,
              f"chain run bound calls {c['bound_calls_cuda']} on the card, "
              f"{c['bound_calls_torch']} off it")
        check(c["bound_calls_cuda"] == lau["bound_atoms"]
              == c["expand_calls_chain"] and lau["bound"] == 0,
              f"bound_atoms launches {lau['bound_atoms']}, ctj_bound "
              f"launches {lau['bound']}, executor count "
              f"{c['bound_calls_cuda']}, chain EXPANDs "
              f"{c['expand_calls_chain']}")
        check(c["expand_calls_chain"] > 0 and c["expand_calls_cuda"] == 0
              and lau["expand"] == 0, "a chain run launched a fused EXPAND")
    c2 = res2.counters
    check(c2["fold_calls_torch"] == 0 and c2["emit_calls_torch"] == 0
          and launches["fold_replay"] == c2["fold_calls_cuda"]
          and launches["emit"] == c2["emit_calls_cuda"] > 0,
          "wrapper launches != executor counts in chain evaluate")
    # the reference's public bounded search on the card: C queries, each
    # window a run of the wiki-Vote-scale plan's largest trie level
    col, v, lo, hi = bound_inputs(cycle_engine(db, dev)[0],
                                  np.random.default_rng(SEED), dev)
    before = read_launches()
    s = registry.lower_bound(col, v, lo, hi, impl="leapfrog")
    e = registry.upper_bound(col, v, s, hi, impl="leapfrog")
    torch.cuda.synchronize()
    after = read_launches()
    check(after["bound"] - before["bound"] == 2
          and after["bound_atoms"] == before["bound_atoms"],
          "the public bounded search did not launch ctj_bound twice")
    for name in launches:
        launches[name] += after[name] - before[name]
    check(torch.equal(s, registry.lower_bound(col, v, lo, hi))
          and torch.equal(e, registry.upper_bound(col, v, s, hi)),
          "registry bounds with impl=leapfrog differ from impl=bsearch")
    note = cap.check()
    print(f"[12 leapfrog] expand_kernel=chain impl=leapfrog, 4-cycle: count "
          f"at wiki-Vote scale {res.count} (oracle, = fused) exec_s="
          f"{res.exec_s:.3f} chain EXPANDs {res.counters['expand_calls_chain']}"
          f" bound calls {res.counters['bound_calls_cuda']}; evaluate at "
          f"ca-GrQc scale rows={want2} (oracle) = fused row for row, exec_s="
          f"{res2.exec_s:.3f} chain EXPANDs {c2['expand_calls_chain']} bound "
          f"calls {c2['bound_calls_cuda']}; captured: {note}; "
          f"registry.lower_bound/upper_bound(impl=leapfrog) on {C} queries "
          f"(N={col.numel()}) = impl=bsearch | launches "
          + json.dumps(launches), flush=True)
    return dict(launches=launches)


def serve_phase(q, db2, want2: int) -> dict:
    """Phase 13: ``engine.serve`` with ``GPU_SERVE`` on the ca-GrQc-scale
    graph: the 4-cycle (a plan-cache miss), the same query with renamed
    variables (a hit whose warm tables replay, rows in the client's
    names), a 3-path count, SERVE_STREAMS concurrent streaming sessions,
    each equal to the oracle; a snapshot that a fresh process
    (``--serve-worker``) loads and serves warm from; and a server on the
    chain path (``JoinEngineConfig(expand_kernel="chain",
    impl="leapfrog")``) answering one count.  Returns the launches and the
    open ``GPU_SERVE`` server (phase 7 profiles a warm query on it)."""
    import threading
    q2, q3 = renamed(q), path_query(3)
    want3 = path_oracle(db2, 3)
    reset_launches()
    srv = engine.serve(db2, config=GPU_SERVE)
    r1 = srv.evaluate(q)
    check(not r1.plan_cache_hit, "the first query hit the plan cache")
    check_rows(r1.tuples, r1.order, q, db2, want2, "serve miss")
    r2 = srv.evaluate(q2)
    check(r2.plan_cache_hit and r2.tier2_replay_hits > 0,
          f"renamed query: plan-cache hit {r2.plan_cache_hit}, replay hits "
          f"{r2.tier2_replay_hits}")
    check_rows(r2.tuples, r2.order, q2, db2, want2, "serve warm hit")
    r3 = srv.count(q3)
    check(r3.count == want3, f"serve 3-path count {r3.count} != {want3}")
    out, errors = [None] * SERVE_STREAMS, []

    def drain(i, sess):
        try:
            out[i] = (list(sess.blocks()), sess.result(timeout=600))
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    t0 = time.perf_counter()
    sessions = [srv.evaluate_stream(q) for _ in range(SERVE_STREAMS)]
    threads = [threading.Thread(target=drain, args=(i, s_))
               for i, s_ in enumerate(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    streams_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    check(all(o is not None for o in out), "a streaming session hung")
    for i, (blocks, res) in enumerate(out):
        check_rows(np.concatenate(blocks), res.order, q, db2, want2,
                   f"stream session {i}")
    launches = read_launches()
    results = [r1, r2, r3] + [res for _, res in out]

    def total(key):
        return sum(r.counters.get(key, 0) for r in results)

    check(launches["expand"] == total("expand_calls_cuda") > 0
          and total("expand_calls_torch") == 0
          and launches["fold_splice"] == total("fold_splice_calls_cuda") > 0
          and launches["fold_replay"] == total("fold_calls_cuda")
          - total("fold_splice_calls_cuda")
          and launches["emit"] == total("emit_calls_cuda")
          and total("fold_calls_torch") + total("emit_calls_torch") == 0,
          "wrapper launches != the sessions' executor counts")
    work = ROOT / "build" / f"chip_smoke_serve_{int(time.time() * 1e3)}"
    work.mkdir(parents=True)
    proc = None
    try:
        snap = work / "serve.npz"
        _, save_s = host_synced(lambda: srv.save_snapshot(str(snap)))
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-worker",
             str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        wout = proc.communicate(timeout=SERVE_WORKER_TIMEOUT_S)[0]
        check(proc.returncode == 0,
              f"serve worker exited {proc.returncode}:\n{wout[-4000:]}")
        worker = json.loads((work / "serve_worker.json").read_text())
        snap_mb = snap.stat().st_size / 2 ** 20
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    before = read_launches()
    with engine.serve(db2, config=JoinEngineConfig(**CHAIN)) as lf:
        r4 = lf.count(q)
    after = read_launches()
    c4 = r4.counters
    check(r4.count == want2, f"chain server count {r4.count} != {want2}")
    check(c4["bound_calls_cuda"]
          == after["bound_atoms"] - before["bound_atoms"] > 0
          and c4["bound_calls_torch"] == 0 and c4["expand_calls_cuda"] == 0
          and c4["expand_calls_chain"] > 0,
          f"chain server: counters {c4} vs bound launches "
          f"{after['bound_atoms'] - before['bound_atoms']}")
    print(f"[13 serve] engine.serve(GPU_SERVE) on the ca-GrQc-scale graph: "
          f"4-cycle miss rows={want2} (oracle) wall_s={r1.wall_s:.3f} "
          f"exec_s={r1.exec_s:.3f}; renamed 4-cycle plan-cache hit, replay "
          f"hits {r2.tier2_replay_hits}, rows (oracle, client names "
          f"{list(r2.order)}) wall_s={r2.wall_s:.3f}; 3-path count "
          f"{r3.count} (oracle) wall_s={r3.wall_s:.3f} (miss); "
          f"{SERVE_STREAMS} concurrent streams, each the oracle's rows, "
          f"{streams_s:.3f} s together, replay hits "
          f"{[res.tier2_replay_hits for _, res in out]}; snapshot "
          f"{snap_mb:.2f} MiB saved in {save_s:.3f} s; fresh process: "
          f"{json.dumps(worker)}; chain server count {r4.count} (oracle) "
          f"wall_s={r4.wall_s:.3f} bound calls {c4['bound_calls_cuda']} | "
          f"server stats {json.dumps(srv.stats())} | launches "
          + json.dumps(after), flush=True)
    return dict(launches=after, server=srv, query=q2)


def serve_worker(work: str) -> int:
    """Phase 13's fresh process (``chip_smoke.py --serve-worker DIR``):
    load DIR/serve.npz into a new ``GPU_SERVE`` server over the
    ca-GrQc-scale graph, then answer the renamed 4-cycle: it must hit the
    loaded plan, replay from the loaded tables and give the oracle's
    rows.  Writes what it saw to DIR/serve_worker.json."""
    db2 = grqc_db()
    q2 = renamed(cycle_query(4))
    want2 = cycle_oracle(db2, 4)
    with engine.serve(db2, config=GPU_SERVE) as srv:
        summary, load_s = host_synced(
            lambda: srv.load_snapshot(str(Path(work) / "serve.npz")))
        res = srv.evaluate(q2)
    check(summary["status"] == "ok" and summary["plans"] >= 1
          and summary["tables"] >= 1 and summary["flushed"] == 0,
          f"snapshot load: {summary}")
    check(res.plan_cache_hit and res.tier2_replay_hits > 0,
          f"first query: plan-cache hit {res.plan_cache_hit}, replay hits "
          f"{res.tier2_replay_hits}")
    check_rows(res.tuples, res.order, q2, db2, want2, "serve worker")
    (Path(work) / "serve_worker.json").write_text(json.dumps(dict(
        load=summary, load_s=load_s, first_query_wall_s=res.wall_s,
        exec_s=res.exec_s, compile_s=res.compile_s,
        replay_hits=res.tier2_replay_hits, rows=res.count)))
    return 0


def knobs_phase(q, db2, want2: int, fused_rows, pay_ref: dict,
                static_ref: dict, dev) -> dict:
    """Phase 15: the reference's knobs.  (a) The FOLD and EMIT op chains
    (``OP_CHAINS``) on the card at ca-GrQc scale: a one-shot evaluation
    at C, a cold and a warm pass on one ``GPU_EVAL_REPLAY`` engine, and a
    static evaluation cold and warm at C_STATIC; each run's rows equal the
    fused run's in order (phases 5, 8 and 10), the replay hits equal
    phases 8 and 10's, and not one FOLD or EMIT kernel ran while EXPAND's
    did.  (c) The paper's host engines (``backend="ref"``: CLFTJ, LFTJ,
    YTD, and the host CLFTJ under ``PAPER_FAITHFUL`` and ``BOUNDED_100K``)
    counting the triangle on the reference benchmark's ego-facebook-like
    graph, and one host CLFTJ evaluation: every count equals the device
    engine's on the card and scipy's, the tuples the device engine's."""
    td2, order2 = engine.plan_query(q, db2)
    reset_launches()
    runs = []

    def measured(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, secs = host_synced(fn)
        runs.append(f"{label} {secs:.3f} s, peak "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        return out

    # (a) the op chains: one-shot evaluation
    res = measured("evaluate", lambda: engine.evaluate(q, db2, capacity=C,
                                                       **OP_CHAINS))
    check_rows(res.tuples, res.order, q, db2, want2, "chain evaluate")
    check(np.array_equal(res.tuples, fused_rows),
          "chain FOLD/EMIT evaluate rows differ from the fused run's")
    counters = [res.counters]
    # a payload engine of GPU_EVAL_REPLAY with both chains, cold and warm
    cfg = dataclasses.replace(GPU_EVAL_REPLAY, **OP_CHAINS)
    check(cfg.cache_config() == PAYLOAD_CACHE
          and cfg.frontier_capacity == C,
          "GPU_EVAL_REPLAY is not phase 8's payload configuration")
    pay = CachedTrieJoin(q, td2, order2, db2, capacity=cfg.frontier_capacity,
                         dedup=cfg.dedup, cache=cfg.cache_config(),
                         device=dev, impl=cfg.impl,
                         expand_kernel=cfg.expand_kernel,
                         fold_kernel=cfg.fold_kernel,
                         emit_kernel=cfg.emit_kernel)
    for i, label in enumerate(("cold", "warm")):
        hits0 = pay.stats["tier2_replay_hits"]
        rows, _ = measured(f"payload {label}", lambda: timed_pass(pay))
        check(digest(rows) == pay_ref["digests"][i],
              f"chain payload {label} rows differ from phase 8's")
        hits = pay.stats["tier2_replay_hits"] - hits0
        check(hits == pay_ref["hits"][i],
              f"chain payload {label} replay hits {hits} != phase 8's "
              f"{pay_ref['hits'][i]}")
    counters.append(pay.stats)
    # the static executor, one pass per call, both chains
    se = StaticCLFTJ(q, td2, order2, db2, capacity=C_STATIC,
                     cache=PAYLOAD_CACHE, device=dev, **OP_CHAINS)
    tables = None
    for i, label in enumerate(("cold", "warm")):
        with SyncCounter() as sync:
            rows, st, tables = measured(f"static {label}",
                                        lambda: se.evaluate_static(tables))
        check(digest(rows) == static_ref["digests"][i]
              and st == static_ref["stats"][i],
              f"chain static {label}: {st} or its rows differ from phase "
              f"10's {static_ref['stats'][i]}")
        check(sync.label_counts == {"static-eval": 1},
              f"chain static {label} fetched {dict(sync.label_counts)}")
    counters.append(se.stats)
    del se, tables, pay
    gc.collect()
    torch.cuda.empty_cache()
    chain_launches = read_launches()
    for name in ("fold_replay", "fold_splice", "fold_merged", "emit"):
        check(chain_launches[name] == 0,
              f"the op chains launched {name} {chain_launches[name]} times")
    expands = sum(c["expand_calls_cuda"] for c in counters)
    check(chain_launches["expand"] == expands > 0,
          f"expand launches {chain_launches['expand']} != executor count "
          f"{expands}")
    for c in counters:
        check(c["fold_calls_chain"] > 0 and c["emit_calls_chain"] > 0
              and all(c[f"{op}_calls_{p}"] == 0
                      for op in ("fold", "emit") for p in ("cuda", "torch")),
              "a FOLD or EMIT left the op chains")
    check(counters[1]["fold_splice_calls_chain"] > 0
          and counters[2]["fold_merged_calls_chain"] > 0,
          "the chains spliced or merged nothing")
    print(f"[15 knobs] fold_kernel=chain emit_kernel=chain, 4-cycle at "
          f"ca-GrQc scale: evaluate C={C} rows={want2} (oracle) = phase 5 "
          f"in order; GPU_EVAL_REPLAY engine cold/warm = phase 8 in order, "
          f"replay hits {pay_ref['hits']}; static C={C_STATIC} cold/warm = "
          f"phase 10 in order, {static_ref['stats']}; FOLD/EMIT kernel "
          f"launches 0, EXPAND {chain_launches['expand']}; wall and peak "
          f"device memory: " + "; ".join(runs)
          + f" (fused: static peak {static_ref['peak_gib']:.2f} GiB)",
          flush=True)

    # (c) the host engines beside the device engine
    t0 = time.perf_counter()
    dbh = dataset(HOST_DATASET)
    qt = cycle_query(3)
    td, order = engine.plan_query(qt, dbh)
    want = cycle_oracle(dbh, 3)
    dev_count = engine.count(qt, dbh, td=td, order=order, capacity=C)
    dev_eval = engine.evaluate(qt, dbh, td=td, order=order, capacity=C)
    check(dev_count.count == dev_eval.count == want,
          f"device triangle count {dev_count.count} / {dev_eval.count} != "
          f"scipy oracle {want}")
    host = []
    host_runs = [(a, dict(algorithm=a)) for a in HOST_ALGORITHMS] + [
        (name, dict(algorithm="clftj", policy=preset.host_policy()))
        for name, preset in (("PAPER_FAITHFUL", PAPER_FAITHFUL),
                             ("BOUNDED_100K", BOUNDED_100K))]
    for label, kw in host_runs:
        r = engine.count(qt, dbh, td=td, order=order, backend="ref", **kw)
        check(r.count == want and r.backend == "ref",
              f"host {label} count {r.count} != {want}")
        host.append(f"{label} {r.exec_s:.3f} s")
    ev = engine.evaluate(qt, dbh, td=td, order=order, backend="ref",
                         algorithm="clftj")
    check(ev.count == want and set(map(tuple, ev.tuples.tolist()))
          == set(map(tuple, dev_eval.tuples.tolist())),
          "host CLFTJ tuples differ from the device engine's")
    host.append(f"clftj evaluate {ev.exec_s:.3f} s")
    launches = read_launches()
    print(f"[15 knobs] host engines, backend=ref, triangle on "
          f"{HOST_DATASET} ({dbh.relations['E'].shape[0]} directed edges): "
          f"count {want} (scipy oracle) = device engine's count and "
          f"evaluate (exec_s {dev_count.exec_s:.3f} / {dev_eval.exec_s:.3f})"
          f"; every host count equal, host tuples = device tuples; "
          f"exec_s " + ", ".join(host)
          + f"; (c) took {time.perf_counter() - t0:.1f} s | launches "
          + json.dumps(launches), flush=True)
    return dict(launches=launches)


def flash_pairs(t: int, s: int, causal: bool, window, q_offset: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    qpos = q_offset + np.arange(t, dtype=np.int64)
    hi = np.minimum(qpos, s - 1) if causal else np.full(t, s - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(t, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# phase 17's flash shapes timed beside qwen2.5-3b's prefill (PERF.md
# rows 5'): FLASH_CASES index, label
FLASH_FAMILY_ROWS = [(11, "recurrentgemma local prefill"),
                     (12, "VLM cross prefill"), (13, "VLM cross decode step"),
                     (14, "whisper encoder")]


def flash_row(case, q, k, v, err) -> dict:
    """Times of the kernel on one case's bf16 inputs: CUDA events and
    device busy, the plain version, SDPA (the library's attention, timed
    only: the port never calls it; a window is a boolean mask there),
    and the bound (the unmasked pairs' FLOPs at the tensor cores' peak,
    or the inputs read and the output written once)."""
    b, t, s, h, hkv, dh, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    pairs = flash_pairs(t, s, causal, window, q_offset)
    flops = 4 * b * h * dh * pairs
    moved = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    by_ops, by_bytes = flops / TC_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None
    if window is not None:
        qpos = q_offset + torch.arange(t, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        mask = (kpos > qpos - window) & (kpos <= qpos if causal else True)
    sdpa_kw = dict(enable_gqa=hkv != h)
    if mask is not None:
        sdpa_kw["attn_mask"] = mask
    else:
        sdpa_kw["is_causal"] = causal
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: flash_cuda.flash_attention(q, k, v, **kw)),
        **busy(lambda: flash_cuda.flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(lambda: flash_plain.flash_attention(q, k, v, **kw)),
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, **sdpa_kw)),
        bound_ms=max(by_ops, by_bytes),
        bound_by="operations" if by_ops >= by_bytes else "bytes",
        note=(f"B={b} T={t} S={s} H={h} Hkv={hkv} Dh={dh} "
              f"{'causal' if causal else 'non-causal'}"
              + (f" window {window}" if window else "")
              + f" bf16, {flops / 1e9:.1f} GFLOP, {moved / 2 ** 20:.1f} MiB"))


def flash_phase(dev) -> dict:
    """Phase 14, part 1: the flash kernel against its plain version on
    every FLASH_CASES case in bf16 and fp32, within FLASH_TOL; times at
    qwen2.5-3b's prefill shape in bf16 (the model's dtype), and at phase
    17's shapes (FLASH_FAMILY_ROWS), by ``flash_row``."""
    worst, inputs = {}, {}
    main_case = FLASH_CASES[7]
    timed = {main_case} | {FLASH_CASES[i] for i, _ in FLASH_FAMILY_ROWS}
    for case in FLASH_CASES:
        b, t, s, h, hkv, dh, causal, window, q_offset = case
        rng = np.random.default_rng(list(case[:6]) + [q_offset])
        draws = [rng.standard_normal(shape, dtype=np.float32) for shape in
                 ((b, t, h, dh), (b, s, hkv, dh), (b, s, hkv, dh))]
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for dtype, tol in FLASH_TOL.items():
            q, k, v = (torch.from_numpy(x).to(dev, dtype) for x in draws)
            got = flash_cuda.flash_attention(q, k, v, **kw).float()
            want = flash_plain.flash_attention(q, k, v, **kw).float()
            err = float((got - want).abs().max())
            check(close_excess(got, want, tol) <= 0, f"flash {case} {dtype}: "
                  f"max abs error {err} outside {tol} abs + {tol} rel")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            if case in timed and dtype == torch.bfloat16:
                inputs[case] = (q, k, v, err)
            del got, want
    row = flash_row(main_case, *inputs[main_case])
    family = {label: flash_row(FLASH_CASES[i], *inputs[FLASH_CASES[i]])
              for i, label in FLASH_FAMILY_ROWS}
    del inputs

    def fmt(r):
        return (f"{r['ms']:.4f} ms, device busy {r['busy_ms']:.4f} ms "
                f"(plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} "
                f"ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']}), max "
                f"abs error {r['max_abs_err']:.3g}")
    print(f"[14 lm] flash kernel vs plain on {len(FLASH_CASES)} cases x "
          f"{{bf16, fp32}}: max abs error "
          + ", ".join(f"{str(d)[6:]} {e:.3g} (tol {FLASH_TOL[d]})"
                      for d, e in worst.items())
          + f"; at qwen2.5-3b's prefill ({row['note']}): {fmt(row)}",
          flush=True)
    print("[14 lm] flash at phase 17's shapes: " + "; ".join(
        f"{label} ({r['note']}): {fmt(r)}" for label, r in family.items()),
        flush=True)
    row["family"] = family
    return row


def close_excess(got: torch.Tensor, want: torch.Tensor, tol: float,
                 rel: float | None = None) -> float:
    """max(|got - want| - tol - rel |want|), rel defaulting to tol: <= 0
    when within tol absolute plus rel relative."""
    rel = tol if rel is None else rel
    return float(((got - want).abs() - tol - rel * want.abs()).max())


def decode_replay(model, batch: dict, toks: torch.Tensor):
    """The greedy tokens replayed (teacher forcing): prefill the batch's
    prompt (with its image or audio embeds), decode toks[:, :-1];
    (every step's logits (B, steps, V), prefill s, decode s)."""
    prompt = batch["tokens"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = model.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    caches = pad_caches(model.cfg, caches, toks.shape[1])
    steps = [lg]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(toks.shape[1] - 1):
        lg, caches = model.decode(caches, toks[:, i:i + 1],
                                  prompt.shape[1] + i)
        steps.append(lg)
    torch.cuda.synchronize()
    return torch.stack(steps, dim=1), prefill_s, time.perf_counter() - t0


def forward_at_steps(model, batch: dict, toks: torch.Tensor):
    """The full forward over the prompt + toks[:, :-1]: the logits at
    every position that ``decode_replay`` predicts from (B, steps, V)."""
    prompt = batch["tokens"]
    full = model(dict(batch, tokens=torch.cat([prompt, toks[:, :-1]],
                                              dim=1)))
    return full[:, prompt.shape[1] - 1:].clone()


def lm_phase(dev) -> dict:
    """Phase 14, part 2: qwen2.5-3b at full width and depth on the card,
    weights from a seeded torch.Generator, four 2048-token prompts from
    data/tokens.py under ``greedy_generate`` for LM_STEPS tokens: one
    flash launch a layer a prefill and none in decode; a teacher-forced
    replay of the greedy tokens times the prefill and the decode steps and
    gives every step's logits (finite; their argmax is the greedy token).
    A full forward over prompt and tokens reproduces every step's logits
    (LM_TOL absolute + relative in bf16 compute; LM_DECODE_TOL_FP32
    absolute with the same weights in fp32 compute); ``impl="chain"``
    gives the same prefill logits (LM_TOL; LM_TOL_FP32 in fp32 compute)
    and the same tokens wherever the top-2 margin exceeds LM_TOL."""
    cfg = get_arch(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    model.reset_parameters(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.param_count() == cfg.param_count(),
          f"{LM_ARCH} has {model.param_count()} parameters, its specs "
          f"{cfg.param_count()}")
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=LM_PROMPT,
                                global_batch=LM_BATCH, seed=SEED), 0)
    prompt = torch.from_numpy(batch["tokens"]).to(dev)
    reset_launches()
    out, gen_s = host_synced(
        lambda: greedy_generate(model, {"tokens": prompt}, LM_STEPS))
    launches = read_launches()
    check(out.shape == (LM_BATCH, LM_STEPS) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), f"greedy tokens {out.shape}")
    check(launches["flash_attention"] == cfg.n_layers,
          f"greedy_generate launched the flash kernel "
          f"{launches['flash_attention']} times, not {cfg.n_layers} (one a "
          f"layer of its one prefill; decode launches none)")
    check(all(n == 0 for k, n in launches.items() if k not in LM_ONLY),
          f"the LM launched join kernels: {launches}")

    toks = out.to(dev)
    steps, prefill_s, decode_s = decode_replay(model, {"tokens": prompt},
                                               toks)
    check(bool(torch.isfinite(steps).all()), "non-finite logits")
    check(torch.equal(steps.argmax(-1).cpu().to(torch.int32), out),
          "the replayed logits' argmax differs from the greedy tokens")
    top2 = steps.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu()
    want = forward_at_steps(model, {"tokens": prompt}, toks)
    dec_err = float((steps - want).abs().max())
    check(close_excess(steps, want, LM_TOL) <= 0,
          f"prefill + decode vs forward: max abs error {dec_err} outside "
          f"{LM_TOL} abs + {LM_TOL} rel")
    del want

    # the same weights in fp32 compute: decode vs the full forward to the
    # bf16 cache's rounding, and the kernel's prefill against the plain
    # attention's to fp32 rounding
    model.cfg = dataclasses.replace(cfg, dtype_compute="float32")
    steps32, _, _ = decode_replay(model, {"tokens": prompt}, toks)
    want = forward_at_steps(model, {"tokens": prompt}, toks)
    dec_err32 = float((steps32 - want).abs().max())
    check(dec_err32 <= LM_DECODE_TOL_FP32,
          f"fp32 compute: prefill + decode vs forward max abs error "
          f"{dec_err32} outside {LM_DECODE_TOL_FP32} abs")
    del want
    lg32 = steps32[:, 0]
    model.impl = "chain"
    lg32_chain, _ = model.prefill({"tokens": prompt})
    model.cfg = cfg
    err32 = float((lg32 - lg32_chain).abs().max())
    check(close_excess(lg32, lg32_chain, LM_TOL_FP32) <= 0,
          f"fp32 compute: fused vs chain prefill logits max abs error "
          f"{err32} outside {LM_TOL_FP32} abs + {LM_TOL_FP32} rel")
    del steps32, lg32, lg32_chain
    fused_launches = flash_cuda.launches
    check(fused_launches == 5 * cfg.n_layers,
          f"{fused_launches} flash launches, not one a layer of each of the "
          f"five fused prefills and forwards (greedy, replay and forward in "
          f"bf16, replay and forward in fp32)")

    # impl="chain" in bf16: the plain blocked attention on the card
    lg_chain, _ = model.prefill({"tokens": prompt})
    impl_err = float((lg_chain - steps[:, 0]).abs().max())
    check(close_excess(lg_chain, steps[:, 0], LM_TOL) <= 0,
          f"fused vs chain prefill logits: max abs error {impl_err} outside "
          f"{LM_TOL} abs + {LM_TOL} rel")
    out_chain = greedy_generate(model, {"tokens": prompt}, LM_STEPS)
    model.impl = "fused"
    check(flash_cuda.launches == fused_launches,
          "impl='chain' launched the flash kernel")
    near, diverged = int((margin <= LM_TOL).sum()), []
    for r in range(LM_BATCH):
        for i in range(LM_STEPS):
            if out[r, i] != out_chain[r, i]:
                check(margin[r, i] <= LM_TOL,
                      f"row {r} step {i}: fused and chain tokens differ at "
                      f"a top-2 margin of {float(margin[r, i])}")
                diverged.append((r, i))
                break          # the contexts differ from here on
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    lm_launches = read_launches()
    n_tok = LM_BATCH * LM_PROMPT
    tol = f"{LM_TOL} abs + {LM_TOL} rel"
    print(f"[14 lm] {LM_ARCH} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, Dh "
          f"{cfg.dh}, vocab {cfg.vocab}, {model.param_count()} fp32 params, "
          f"bf16 compute), init {init_s:.3f} s; greedy_generate of "
          f"{LM_STEPS} tokens on {LM_BATCH} x {LM_PROMPT}-token prompts: "
          f"{gen_s:.3f} s; prefill {prefill_s:.3f} s = "
          f"{n_tok / prefill_s:.0f} tokens/s; decode "
          f"{1e3 * decode_s / (LM_STEPS - 1):.3f} ms/step = "
          f"{LM_BATCH * (LM_STEPS - 1) / decode_s:.1f} tokens/s; logits "
          f"finite; decode vs forward max abs error {dec_err:.4g} (tol "
          f"{tol}), in fp32 compute {dec_err32:.4g} (tol "
          f"{LM_DECODE_TOL_FP32} abs); fused vs chain prefill logits "
          f"{impl_err:.4g} (tol {tol}), in fp32 compute {err32:.4g} (tol "
          f"{LM_TOL_FP32} abs + {LM_TOL_FP32} rel); top-2 margin min "
          f"{float(margin.min()):.4g} median "
          f"{float(margin.median()):.4g}, {near} of {margin.numel()} steps "
          f"at or below {LM_TOL}; chain tokens "
          f"= fused tokens "
          + (f"but for rows diverging after near-ties at (row, step) "
             f"{diverged}" if diverged else "at every step")
          + f"; peak device memory {peak_gib:.2f} GiB | launches "
          + json.dumps(lm_launches), flush=True)
    return dict(model=model, prompt=prompt, launches=lm_launches,
                tokens=out)


# phase 16: training qwen2.5-3b at full width and depth.  (a) one
# sequence of TRAIN_SEQ tokens; (b) TRAIN_STEPS steps of make_train_step
# on one fixed batch of TRAIN_BATCH sequences in TRAIN_MB microbatches
# (phase 14's 4 x 2048 tokens); (c) each remat policy one step at
# TRAIN_REMAT_LAYERS layers; (d) the loop at one layer, crash at step
# TRAIN_CRASH of TRAIN_LOOP_STEPS, checkpoints every TRAIN_CKPT_EVERY
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = 2048, 4, 2, 4
TRAIN_OPT = OptConfig(lr=1e-4, warmup_steps=2, decay_steps=100)
TRAIN_REMAT_LAYERS = 1
TRAIN_LOOP_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH = 6, 3, 4
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
# (a) bounds on the relative L2 error ||g_fused - g_chain|| / ||g_chain||
# of every parameter's gradient, fused (the kernel in the forward pass,
# the plain path differentiated in backward) against chain (the plain
# path both ways).  Both differentiate the same function; they differ
# only by the forward activations that reach each layer, the kernel's
# output against the plain version's: FLASH_TOL apart, 2e-5 in fp32 and
# 2e-2 (p rounded to bf16 on the tensor cores) in bf16, compounding
# over 36 layers.  On an H100 the worst tensor read 2.16e-5 in fp32 and
# 0.0889 in bf16 (the last layer's wk); the bounds are 1e-3 and twice
# that bf16 reading (as LM_TOL is for the serving path's bf16 noise).
# The planted fault (the kernel's output detached, as before the
# autograd Function) loses attention's whole share of the q/k/v
# projections' gradients: relative error 1 there (read 1 in both
# dtypes); it must read at least TRAIN_FAULT_MIN, above both bounds.
TRAIN_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.2}
TRAIN_FAULT_MIN = 0.5
# (c) the remat policies against "full": one step from the same seed
# runs the same forward ops (remat only recomputes them), so the losses
# are equal; the gradients differ only by the order of the embedding
# gradient's atomic adds (PyTorch's CUDA index backward), so grad_norm
# and the updated parameters within TRAIN_REMAT_TOL relative / absolute
TRAIN_REMAT_TOL = 1e-4
# (d) a resumed run against a straight one: the same data and state
# (the card's runs have read 0 apart), so the losses within
# TRAIN_RESUME_TOL relative, the CPU test's bound.  A planted resume
# that restores the parameters but loses AdamW's m and v must read
# above it.
TRAIN_RESUME_TOL = 1e-5


def rel_l2(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| per tensor (0 where both are zero); a
    gradient that is None (no path reached the parameter) counts as 0."""
    out = {}
    for name, w in want.items():
        den = float(w.float().norm())
        g = got[name]
        num = den if g is None else float((g.float() - w.float()).norm())
        out[name] = num / den if den else (0.0 if num == 0 else math.inf)
    return out


def loss_grads(model, batch) -> tuple:
    """(loss, every parameter's gradient) of one ``Model.loss``; the
    gradients are handed over (``.grad`` is left empty)."""
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name], p.grad = p.grad, None
    return float(loss.detach()), grads


def detached_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                       impl="fused", **kw):
    """The fault that FlashAttention repairs, planted here: the kernel's
    output with no autograd node."""
    return flash_cuda.flash_attention(q.detach(), k.detach(), v.detach(),
                                      causal=causal, window=window,
                                      q_offset=q_offset)


def grad_check(model, batch, dtype) -> dict:
    """Phase 16 (a) in one compute dtype: fused against chain, and the
    planted fault against chain."""
    model.cfg = dataclasses.replace(model.cfg, dtype_compute={
        torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype])
    model.impl = "chain"
    loss_c, chain = loss_grads(model, batch)
    model.impl = "fused"
    before = flash_cuda.launches
    loss_f, fused = loss_grads(model, batch)
    launches = flash_cuda.launches - before
    err = rel_l2(fused, chain)
    del fused
    real = flash_ops.flash_attention
    flash_ops.flash_attention = detached_attention
    try:
        _, faulty = loss_grads(model, batch)
    finally:
        flash_ops.flash_attention = real
    fault = rel_l2(faulty, chain)
    del faulty, chain
    worst = max(err, key=err.get)
    worst_fault = max(fault, key=fault.get)
    tol = TRAIN_GRAD_TOL[dtype]
    name = str(dtype)[6:]
    check(all(math.isfinite(e) for e in err.values()),
          f"(a) {name}: a non-finite gradient error")
    check(err[worst] <= tol, f"(a) {name}: fused vs chain gradient of "
          f"{worst}: relative L2 error {err[worst]} above {tol}")
    check(fault[worst_fault] >= TRAIN_FAULT_MIN > tol,
          f"(a) {name}: the planted fault reads only "
          f"{fault[worst_fault]} ({worst_fault})")
    check(launches == 2 * model.cfg.n_layers,
          f"(a) {name}: {launches} flash launches, not 2 a layer")
    return dict(loss_fused=loss_f, loss_chain=loss_c, err=err[worst],
                worst=worst, fault=fault[worst_fault],
                fault_worst=worst_fault, launches=launches)


def train_steps(model, batch, steps: int) -> dict:
    """Phase 16 (b): ``steps`` train steps on one batch; per step the
    flash launches, the FlashAttention backward recomputes and the plain
    path's calls (counted through the module attribute the backward
    calls), each step's seconds to the host's loss; ``live``, the FLOPs
    of the first step (the warm-up, left out of the median step time)
    counted on the card for phase 19 (a) by ``costprobe.live_count``;
    and ``step``, a callable that takes one more step from where they
    ended."""
    step_fn = make_train_step(model, TrainConfig(microbatches=TRAIN_MB,
                                                 opt=TRAIN_OPT))
    state = init_train_state(model)
    plain_calls = [0]
    real = flash_plain.flash_attention

    def counted(*a, **kw):
        plain_calls[0] += 1
        return real(*a, **kw)

    out = dict(loss=[], grad_norm=[], seconds=[], launches=[], backward=[],
               plain=[])
    flash_plain.flash_attention = counted
    try:
        for i in range(steps):
            before = (flash_cuda.launches, flash_cuda.backward_calls,
                      plain_calls[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                with costprobe.live_count() as live:
                    state, metrics = step_fn(state, batch)
                    torch.cuda.synchronize()
                out["live"] = live
            else:
                state, metrics = step_fn(state, batch)
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
            out["seconds"].append(time.perf_counter() - t0)
            out["launches"].append(flash_cuda.launches - before[0])
            out["backward"].append(flash_cuda.backward_calls - before[1])
            out["plain"].append(plain_calls[0] - before[2])
    finally:
        flash_plain.flash_attention = real
    out["step"] = lambda: step_fn(state, batch)
    return out


def train_phase(dev) -> dict:
    """Phase 16: qwen2.5-3b trained at full width and depth on the card
    (weights from a seeded torch.Generator, bf16 compute, remat "full",
    as the config): (a) loss and every gradient of ``impl="fused"``
    against ``impl="chain"`` on one 2048-token sequence, in fp32 and in
    bf16 compute, and the planted fault; (b) TRAIN_STEPS steps of
    ``make_train_step``, microbatches=2, on one batch of 4 x 2048
    tokens: finite, falling, n_layers x mb x 2 flash launches a step
    (forward and remat recompute) and the plain path only in backward;
    (c) remat "none" and "dots" against "full" at TRAIN_REMAT_LAYERS
    layers; (d) the loop at one layer, crash-resume against a straight
    run, and the launcher (``python -m repro_torch.launch.train``) at
    smoke size."""
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    gen = torch.Generator(device=dev)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in batch_at(data, 0).items()}
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    model.reset_parameters(gen.manual_seed(SEED))

    # (a) fused vs chain gradients, before any optimizer state exists
    one = {k: v[:1] for k, v in batch.items()}
    t0 = time.perf_counter()
    grads = {str(d)[6:]: grad_check(model, one, d)
             for d in (torch.float32, torch.bfloat16)}
    model.cfg = cfg
    grad_s = time.perf_counter() - t0
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the train step (counts read after the step alone)
    t_b = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model.reset_parameters(gen.manual_seed(SEED))
    reset_launches()
    run = train_steps(model, batch, TRAIN_STEPS)
    launches = read_launches()
    peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = n * TRAIN_MB * 2
    check(all(math.isfinite(x) for x in run["loss"] + run["grad_norm"]),
          f"(b) non-finite loss or grad_norm: {run}")
    check(run["loss"][-1] < run["loss"][0],
          f"(b) loss did not fall: {run['loss']}")
    check(run["launches"] == [per_step] * TRAIN_STEPS,
          f"(b) flash launches a step {run['launches']}, not {n} layers x "
          f"{TRAIN_MB} microbatches x 2 (forward, remat recompute)")
    check(run["backward"] == run["plain"] == [n * TRAIN_MB] * TRAIN_STEPS,
          f"(b) backward recomputes {run['backward']} / plain calls "
          f"{run['plain']} a step, not one a layer a microbatch: the "
          f"plain path ran outside FlashAttention's backward")
    check(launches["flash_attention"] == per_step * TRAIN_STEPS and all(
        v == 0 for k, v in launches.items() if k not in LM_ONLY),
        f"(b) launches {launches}")
    # one more step, traced (its launches are not the path's)
    prof = profile_line(run.pop("step"))
    live = dict(run.pop("live"), seconds=run["seconds"][0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    step_s = statistics.median(run["seconds"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ

    b_s = time.perf_counter() - t_b

    # (c) the remat policies at TRAIN_REMAT_LAYERS layers of full width
    t_c = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_REMAT_LAYERS)
    model = Model(cfg4, device=dev)
    remat = {}
    for policy in ("full", "none", "dots"):
        model.cfg = dataclasses.replace(cfg4, remat_policy=policy)
        model.reset_parameters(gen.manual_seed(SEED))
        torch.cuda.reset_peak_memory_stats()
        _, metrics = make_train_step(model, TrainConfig(
            microbatches=TRAIN_MB, opt=TRAIN_OPT))(init_train_state(model),
                                                   batch)
        remat[policy] = dict(loss=float(metrics["loss"]),
                             grad_norm=float(metrics["grad_norm"]),
                             peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        if policy == "full":
            full = {k: p.detach().clone() for k, p in
                    model.named_parameters()}
        else:
            remat[policy]["param_err"] = max(
                float((p.detach() - full[k]).abs().max())
                for k, p in model.named_parameters())
            for key in ("loss", "grad_norm"):
                got, want = remat[policy][key], remat["full"][key]
                check(abs(got - want) <= TRAIN_REMAT_TOL * abs(want),
                      f"(c) {policy} {key} {got} vs full {want}")
            check(remat[policy]["param_err"] <= TRAIN_REMAT_TOL,
                  f"(c) {policy}: parameters {remat[policy]['param_err']} "
                  f"from full's")
    del model, full
    gc.collect()
    torch.cuda.empty_cache()
    c_s = time.perf_counter() - t_c

    # (d) the loop at one layer, its checkpoints under build/
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    model = Model(cfg1, device=dev)
    tcfg = TrainConfig(microbatches=TRAIN_MB, opt=TRAIN_OPT)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def lcfg(name):
        return LoopConfig(total_steps=TRAIN_LOOP_STEPS,
                          ckpt_every=TRAIN_CKPT_EVERY, log_every=1000,
                          keep=1, ckpt_dir=str(TRAIN_DIR / name), seed=SEED)

    # the launcher at smoke size, in its own process beside the loop
    cli_dir = TRAIN_DIR.with_name(TRAIN_DIR.name + "_cli")
    shutil.rmtree(cli_dir, ignore_errors=True)
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         LM_ARCH, "--smoke", "--steps", "3", "--batch", "4", "--seq", "64",
         "--microbatches", "2", "--ckpt-dir", str(cli_dir)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        logs = []
        t0 = time.perf_counter()
        before = flash_cuda.launches
        straight = train(model, data, tcfg, lcfg("straight"),
                         log=logs.append)
        try:
            train(model, data, tcfg, lcfg("resumed"), log=logs.append,
                  fail_at_step=TRAIN_CRASH)
            check(False, "(d) the injected failure did not happen")
        except RuntimeError as e:
            check("injected failure" in str(e), f"(d) {e}")
        ckpt_bytes = sum(f.stat().st_size for f in
                         (TRAIN_DIR / "resumed").rglob("*") if f.is_file())
        # the same checkpoint for the planted resume below
        shutil.copytree(TRAIN_DIR / "resumed", TRAIN_DIR / "lost",
                        copy_function=os.link)
        resumed = train(model, data, tcfg, lcfg("resumed"),
                        log=logs.append)
        loop_launches = flash_cuda.launches - before
        loop_s = time.perf_counter() - t0
        check(f"[resume] restored checkpoint at step {TRAIN_CKPT_EVERY}"
              in logs, f"(d) no resume: {logs}")
        tail = straight["loss"][-len(resumed["loss"]):]

        def loss_err(losses):
            return max(abs(a - b) / abs(b) for a, b in zip(losses, tail))

        resume_err = loss_err(resumed["loss"])
        check(len(resumed["loss"]) == TRAIN_LOOP_STEPS - TRAIN_CKPT_EVERY
              and resume_err <= TRAIN_RESUME_TOL,
              f"(d) resumed losses {resumed['loss']} vs straight {tail}")
        check(loop_launches == 2 * TRAIN_MB * (
            TRAIN_LOOP_STEPS + TRAIN_CRASH + TRAIN_LOOP_STEPS
            - TRAIN_CKPT_EVERY),
            f"(d) {loop_launches} flash launches in the loops")

        real_restore = train_loop.restore_for_mesh

        def restore_losing_moments(*args, **kw):
            saved, state, extra = real_restore(*args, **kw)
            for key in ("m", "v"):
                for t in state["opt"][key].values():
                    t.zero_()
            return saved, state, extra

        train_loop.restore_for_mesh = restore_losing_moments
        try:
            lost = train(model, data, tcfg, lcfg("lost"), log=logs.append)
        finally:
            train_loop.restore_for_mesh = real_restore
        lost_err = loss_err(lost["loss"])
        check(lost_err > TRAIN_RESUME_TOL,
              f"(d) a resume that lost m and v reads {lost_err:.3g}, within "
              f"{TRAIN_RESUME_TOL} of the straight run")
        del model
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        check(not TRAIN_DIR.exists(), "(d) the checkpoints were not removed")
        cli_out, cli_err = cli.communicate(timeout=300)
    finally:
        cli.kill()
        cli.wait()
    cli_s = time.perf_counter() - t_cli
    shutil.rmtree(cli_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    check(cli.returncode == 0 and "[train] done" in cli_out,
          f"(d) the launcher failed: {cli_out[-2000:]} {cli_err[-2000:]}")

    fmt = ", ".join
    print(f"[16 train] {LM_ARCH} ({n} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count()} fp32 params, remat {cfg.remat_policy}); (a) "
          f"one {TRAIN_SEQ}-token sequence, fused vs chain gradients, "
          "relative L2 of the worst tensor: " + fmt(
              f"{k} compute {g['err']:.3g} ({g['worst']}, tol "
              f"{TRAIN_GRAD_TOL[getattr(torch, k)]}; loss fused "
              f"{g['loss_fused']:.6f} chain {g['loss_chain']:.6f}), planted "
              f"fault {g['fault']:.3g} ({g['fault_worst']})"
              for k, g in grads.items())
          + f"; {grad_s:.1f} s, peak {peak_a:.2f} GiB; (b) {TRAIN_STEPS} "
          f"steps, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MB} "
          f"microbatches, bf16 compute: loss " + fmt(
              f"{x:.4f}" for x in run["loss"]) + "; grad_norm " + fmt(
              f"{x:.4f}" for x in run["grad_norm"])
          + f"; step seconds " + fmt(f"{x:.3f}" for x in run["seconds"])
          + f" (median of steps 2-{TRAIN_STEPS} {step_s:.3f} s = "
          f"{tokens / step_s:.0f} tokens/s); flash launches {per_step} a "
          f"step ({n} x {TRAIN_MB} x 2), plain path {n * TRAIN_MB} a step, "
          f"all in FlashAttention's backward; peak device memory "
          f"{peak_b:.2f} GiB; one more step traced: {prof}; {b_s:.1f} s; "
          f"(c) {TRAIN_REMAT_LAYERS} layers, one step: "
          + fmt(f"{p} loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f} "
                f"peak {r['peak']:.2f} GiB"
                + (f" params vs full {r['param_err']:.3g}"
                   if "param_err" in r else "")
                for p, r in remat.items())
          + f"; {c_s:.1f} s; (d) loop at 1 layer, {TRAIN_LOOP_STEPS} steps, crash at "
          f"{TRAIN_CRASH}, resumed from step {TRAIN_CKPT_EVERY}: max "
          f"relative loss difference {resume_err:.3g} (tol "
          f"{TRAIN_RESUME_TOL}; planted resume losing m and v "
          f"{lost_err:.3g}), checkpoint {ckpt_bytes / 1e9:.2f} GB, "
          f"{loop_s:.1f} s, checkpoints removed; launcher at smoke size ok "
          f"({cli_s:.1f} s, beside the loop) | phase "
          f"{time.perf_counter() - t_phase:.1f} s | launches "
          + json.dumps({"flash_attention": launches["flash_attention"]
                        + loop_launches}), flush=True)
    return dict(launches={k: v + (loop_launches if k == "flash_attention"
                                  else 0) for k, v in launches.items()},
                live=live, step_s=step_s)


# phase 17: the other five block families at full width, bf16 compute
# (the configs' own), weights from a seeded torch.Generator with every
# zero- or one-initialised leaf redrawn (FAMILY_REDRAW; left at init they
# hide whole paths: the cross gate's tanh(0) = 0, RWKV's zero token shift
# and bonus).  name, layers run (None: all), batch, prompt, flash launches
# of a prefill and of a decode step.  Depth is cut where the fp32 weights
# would not fit beside the work: phi3.5-moe's 32 layers are 42B
# parameters (168 GB), one of qwen3-moe's 94 layers holds 2.4B in its
# experts (9.7 GB), llama-3.2-vision's 100 layers are 88B; its 5 are one
# pattern group, four "attn" and one "cross".  recurrentgemma's prompt is
# twice its 2048-token window, so the ring wraps in prefill and again in
# decode; whisper's decoder has 448 positions, its prompt 384 + 32.
FAMILY_CELLS = [
    ("recurrentgemma-2b", None, 2, 4096, 8, 0),
    ("rwkv6-7b", None, 2, 2048, 0, 0),
    ("phi3.5-moe-42b-a6.6b", 4, 2, 2048, 4, 0),
    ("qwen3-moe-235b-a22b", 2, 2, 2048, 2, 0),
    ("llama-3.2-vision-90b", 5, 1, 2048, 5, 1),
    ("whisper-tiny", None, 4, 384, 12, 4),
]
FAMILY_STEPS = 16
# the MoE configs' decode vs forward: a prompt of this many tokens at
# capacity_factor = n_experts / top_k, where no choice drops (a decode
# step never drops; a prefill over capacity does)
MOE_CHECK_PROMPT = 256
# each zero- or one-initialised leaf, by name: (mean, std) of a normal
# draw, or "unit" for uniform [0, 1) (tests/test_torch_families.py)
FAMILY_REDRAW = {
    "bq": (0, 0.5), "bk": (0, 0.5), "bv": (0, 0.5), "scale": (1, 0.1),
    "gn_scale": (1, 0.1), "bias": (0, 0.1), "bi": (0, 0.1), "bo": (0, 0.1),
    "conv_b": (0, 0.1), "gate": (0, 0.5), "u": (0, 0.5), "mu_r": "unit",
    "mu_k": "unit", "mu_v": "unit", "mu_g": "unit", "mu_w": "unit",
    "c_mu_k": "unit", "c_mu_r": "unit"}
# bf16 bounds (absolute + relative) of fused vs chain prefill logits (the
# MoE's with the fused routing pinned) and of decode vs the full
# forward, per config, each about twice the larger of the two readings
# an H100 80GB HBM3 at 700 W gave (fused vs chain, decode vs forward):
# recurrentgemma 0.1157, 0.1616; rwkv6 0 (no attention), 0.2148;
# phi3.5-moe 0.1207 (0.6146 on its own routing, 696 of 4,096 tokens
# routed otherwise), 0.1582; qwen3-moe 0.0565 (0.2248, 856 tokens),
# 0.1140; llama-3.2-vision 0.1563, 0.1679; whisper 0.0129, 0.0151.  In
# fp32 compute fused vs chain is held to LM_TOL_FP32 (readings 1.3e-6 to
# 8.7e-5) and decode vs forward, which differ by the bf16 caches, to
# FAMILY_DECODE_TOL_FP32 (absolute), again about twice the readings:
# 0.001022, 7.27e-5, 0.0946, 0.0870, 0.1301, 3.43e-4.
FAMILY_TOL = {"recurrentgemma-2b": 0.3, "rwkv6-7b": 0.4,
              "phi3.5-moe-42b-a6.6b": 0.3, "qwen3-moe-235b-a22b": 0.25,
              "llama-3.2-vision-90b": 0.35, "whisper-tiny": 0.03}
FAMILY_DECODE_TOL_FP32 = {"recurrentgemma-2b": 0.002, "rwkv6-7b": 2e-4,
                          "phi3.5-moe-42b-a6.6b": 0.2,
                          "qwen3-moe-235b-a22b": 0.2,
                          "llama-3.2-vision-90b": 0.25, "whisper-tiny": 1e-3}
# a router near-tie: the K-th and (K+1)-th probabilities closer than this
# fraction of the K-th (two bf16 roundings)
NEAR_TIE = 2 ** -7


def redraw_(model, gen) -> int:
    """Redraw every zero- or one-initialised parameter of ``model`` from
    ``gen`` (FAMILY_REDRAW); returns how many."""
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.spec.init not in ("zeros", "ones"):
                continue
            how = FAMILY_REDRAW[name.rsplit(".", 1)[1]]
            if how == "unit":
                p.uniform_(0.0, 1.0, generator=gen)
            else:
                p.normal_(how[0], how[1], generator=gen)
            n += 1
    return n


class RouteCapture:
    """Records every MoE layer's routing while it is on: for each call of
    ``moe.moe_ffn``, the router's output (``moe.route``: probabilities,
    gates, expert ids, ranks, capacity) in ``routes``, and in ``calls``
    each token's chosen experts with their kept flags, sorted (B, T, K),
    and the margin between its K-th and (K+1)-th router probabilities
    relative to the K-th (B, T).  With ``pin`` (another capture's
    ``routes``), call i routes as that capture's call i did: the same
    experts, ranks and gates, whatever its own router says."""

    def __init__(self, pin=None):
        self.pin = pin

    def __enter__(self):
        self.calls, self.routes = [], []
        self.real_ffn, self.real_route = moe_mod.moe_ffn, moe_mod.route

        def spy(cfg, p, x):
            r = self.real_route(cfg, p, x) if self.pin is None \
                else self.pin[len(self.routes)]
            self.routes.append(r)
            probs, _, ids, rank, cap = r
            b, t, k = x.shape[0], x.shape[1], cfg.top_k
            # a dropped choice reads as expert -1
            kept = torch.where(rank < cap, ids, -1).reshape(b, t, k)
            top = probs.topk(k + 1, dim=-1).values
            margin = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
            self.calls.append((kept.sort(-1).values, margin))
            moe_mod.route = lambda *args: r
            try:
                return self.real_ffn(cfg, p, x)
            finally:
                moe_mod.route = self.real_route

        moe_mod.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        moe_mod.moe_ffn, moe_mod.route = self.real_ffn, self.real_route


def route_flips(a: list, b: list, n_layers: int) -> tuple:
    """Compare two captures of the same positions (each layer's calls,
    in call order, concatenated over time: a prefill, or a prefill and
    its decode steps, or a full forward): (flipped (B, N), True where a
    token's kept experts differ in any layer; near-ties, the (layer,
    token) pairs whose margin is below NEAR_TIE in either capture)."""
    def per_layer(calls):
        return [(torch.cat([r for r, _ in calls[i::n_layers]], 1),
                 torch.cat([m for _, m in calls[i::n_layers]], 1))
                for i in range(n_layers)]
    flipped, near = None, 0
    for (ra, ma), (rb, mb) in zip(per_layer(a), per_layer(b)):
        diff = (ra != rb).any(-1)
        flipped = diff if flipped is None else flipped | diff
        near += int((torch.minimum(ma, mb) < NEAR_TIE).sum())
    return flipped, near


def masked_excess(got, want, keep, tol: float) -> tuple:
    """(close_excess over the rows of got/want (B, N, V) or (B, V) where
    ``keep`` (B, N) or (B,) is True, their max abs error, rows kept)."""
    got, want = got[keep], want[keep]
    if got.numel() == 0:
        return -1.0, 0.0, 0
    return (close_excess(got, want, tol), float((got - want).abs().max()),
            int(keep.sum()))


class FlashTally:
    """Counts the flash kernel's calls by shape (q, k, causal, window,
    dtype) while on, passing each call to the wrapper, which counts its
    launch as always."""

    def __enter__(self):
        self.real, self.shapes = flash_cuda.flash_attention, {}

        def spy(q, k, v, **kw):
            key = (tuple(q.shape), tuple(k.shape), kw.get("causal", True),
                   kw.get("window"), str(q.dtype)[6:])
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return self.real(q, k, v, **kw)

        flash_cuda.flash_attention = spy
        return self

    def __exit__(self, *exc):
        flash_cuda.flash_attention = self.real


def family_run(dev, name: str, depth, batch_n: int, prompt_len: int,
               n_pre: int, n_dec: int) -> dict:
    """One config of phase 17 (see ``family_phase``)."""
    full = get_arch(name)
    cfg = full if depth is None else dataclasses.replace(full,
                                                         n_layers=depth)
    kinds = cfg.layer_kinds()
    attn = sum(k in ("attn", "local", "moe", "cross", "dec") for k in kinds)
    per_prefill = attn + kinds.count("dec") + (
        cfg.n_encoder_layers if cfg.encoder_decoder else 0)
    per_step = kinds.count("cross") + kinds.count("dec")
    check((per_prefill, per_step) == (n_pre, n_dec),
          f"{name}: {per_prefill} / {per_step} attention layers a prefill / "
          f"decode step, the table says {n_pre} / {n_dec}")
    n_moe = kinds.count("moe")
    gen = torch.Generator(device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev)
    model.reset_parameters(gen.manual_seed(SEED))
    n_redrawn = redraw_(model, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.param_count() == cfg.param_count(),
          f"{name}: {model.param_count()} parameters, its specs "
          f"{cfg.param_count()}")
    data = batch_at(DataConfig(vocab=cfg.vocab, seq_len=prompt_len,
                               global_batch=batch_n, seed=SEED), 0)
    batch = {"tokens": torch.from_numpy(data["tokens"]).to(dev)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (batch_n, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device=dev)
    if cfg.encoder_decoder:
        batch["audio_embeds"] = torch.randn(
            (batch_n, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev)

    # greedy_generate: the flash launches of one prefill and 31 steps
    reset_launches()
    out, gen_s = host_synced(
        lambda: greedy_generate(model, batch, FAMILY_STEPS))
    launches = read_launches()
    want_launches = n_pre + (FAMILY_STEPS - 1) * n_dec
    check(out.shape == (batch_n, FAMILY_STEPS) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), f"{name}: tokens {out.shape}")
    check(launches["flash_attention"] == want_launches,
          f"{name}: greedy_generate launched the flash kernel "
          f"{launches['flash_attention']} times, not {want_launches}")
    check(all(n == 0 for k, n in launches.items() if k not in LM_ONLY),
          f"{name}: the LM launched join kernels: {launches}")
    toks = out.to(dev)

    # the replay: timed prefill and decode steps, every step's logits
    with RouteCapture() as fused_routes:
        steps, prefill_s, decode_s = decode_replay(model, batch, toks)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(steps).all()), f"{name}: non-finite logits")
    check(torch.equal(steps.argmax(-1).cpu().to(torch.int32), out),
          f"{name}: the replayed logits' argmax differs from the greedy "
          "tokens")
    res = dict(name=name, layers=cfg.n_layers, params=model.param_count(),
               redrawn=n_redrawn, init_s=init_s, gen_s=gen_s,
               prefill_s=prefill_s,
               decode_ms=1e3 * decode_s / (FAMILY_STEPS - 1),
               peak_gib=peak_gib, flash=launches["flash_attention"])
    tol = FAMILY_TOL[name]

    def fused_vs_chain(lg_fused, fused, what, bound):
        """The chain prefill's last-position logits against the fused
        ones (``fused``: the fused prefill's RouteCapture).  With MoE
        layers the chain prefill runs twice: on its own routing, where
        rows whose last token was routed otherwise are left out and
        counted (in bf16 a near-tie that rounds the other way reroutes a
        token, and its changed state reroutes others in later layers),
        and with the fused prefill's routing pinned, which is held to
        ``bound`` on every row."""
        before = flash_cuda.launches
        model.impl = "chain"
        with RouteCapture() as rc:
            lg_chain, _ = model.prefill(batch)
        out = dict(flips=0, near=0)
        if n_moe:
            flipped, out["near"] = route_flips(fused.calls[:n_moe],
                                               rc.calls, n_moe)
            out["flips"] = int(flipped.sum())
            _, out["own_err"], out["own_rows"] = masked_excess(
                lg_fused, lg_chain, ~flipped[:, -1], bound)
            with RouteCapture(pin=fused.routes[:n_moe]):
                lg_chain, _ = model.prefill(batch)
        model.impl = "fused"
        check(flash_cuda.launches == before,
              f"{name}: impl='chain' launched the flash kernel")
        out["err"] = float((lg_fused - lg_chain).abs().max())
        check(close_excess(lg_fused, lg_chain, bound) <= 0,
              f"{name} {what}: fused vs chain prefill logits max abs error "
              f"{out['err']} outside {bound} abs + {bound} rel")
        return out

    def decode_vs_forward(steps, fused_calls, check_batch, what, bound,
                          rel):
        """Every replayed step's logits against the full forward's,
        positions whose own token was routed otherwise left out."""
        with RouteCapture() as rc:
            want = forward_at_steps(model, check_batch, toks)
        keep = torch.ones(steps.shape[:2], dtype=torch.bool, device=dev)
        flips = near = 0
        if n_moe:
            flipped, near = route_flips(fused_calls, rc.calls, n_moe)
            p = check_batch["tokens"].shape[1]
            keep = ~flipped[:, p - 1:]
            flips = int(flipped.sum())
        excess, err, rows = masked_excess(steps, want, keep, bound)
        if rel:
            ok = excess <= 0
        else:
            ok = err <= bound
        check(ok, f"{name} {what}: decode vs forward max abs error {err} "
              f"outside {bound} abs" + (f" + {bound} rel" if rel else ""))
        check(rows > 0, f"{name} {what}: no position compared")
        return dict(err=err, rows=rows, of=int(keep.numel()), flips=flips,
                    near=near)

    res["bf16_chain"] = fused_vs_chain(steps[:, 0], fused_routes, "bf16",
                                       tol)
    if n_moe:
        # decode vs forward where nothing drops: a shorter prompt at
        # capacity_factor = n_experts / top_k
        check_batch = {"tokens": batch["tokens"][:, :MOE_CHECK_PROMPT]}
        model.cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        with RouteCapture() as rc:
            steps, _, _ = decode_replay(model, check_batch, toks)
        check_calls = rc.calls
    else:
        check_batch, check_calls = batch, []
    res["bf16_decode"] = decode_vs_forward(steps, check_calls, check_batch,
                                           "bf16", tol, True)
    base_cfg = model.cfg
    del steps

    # the same weights in fp32 compute
    model.cfg = dataclasses.replace(cfg, dtype_compute="float32")
    with RouteCapture() as rc:
        lg32, _ = model.prefill(batch)
    res["fp32_chain"] = fused_vs_chain(lg32, rc, "fp32", LM_TOL_FP32)
    model.cfg = dataclasses.replace(base_cfg, dtype_compute="float32")
    with RouteCapture() as rc:
        steps32, _, _ = decode_replay(model, check_batch, toks)
    res["fp32_decode"] = decode_vs_forward(
        steps32, rc.calls, check_batch, "fp32", FAMILY_DECODE_TOL_FP32[name],
        False)
    model.cfg = cfg
    del model, steps32
    gc.collect()
    torch.cuda.empty_cache()
    # every launch of the run: the counts were reset before its greedy
    # generation, and nothing launched before that
    res["launches"] = read_launches()
    return res


def family_phase(dev) -> dict:
    """Phase 17: the reference's other five block families served at full
    width on the card, one config at a time (FAMILY_CELLS), its memory
    freed before the next: weights from a seeded torch.Generator with the
    zero/one leaves redrawn, bf16 compute; ``greedy_generate`` for
    FAMILY_STEPS tokens (the flash launches of one prefill and of
    FAMILY_STEPS - 1 decode steps, the table's counts); a replay of the
    tokens (timed prefill and decode steps; finite logits whose argmax
    is the greedy token); the fused prefill's logits against
    ``impl="chain"``'s (FAMILY_TOL in bf16, LM_TOL_FP32 in fp32
    compute; an MoE's chain prefill with the fused prefill's routing
    pinned, and once more on its own routing, reported); every decode
    step against the full forward over prompt and tokens (FAMILY_TOL in
    bf16, FAMILY_DECODE_TOL_FP32 absolute in fp32; the MoE configs on
    MOE_CHECK_PROMPT tokens at capacity_factor = n_experts / top_k,
    where a position whose own token's kept experts differ between the
    two runs, a router near-tie rounded the other way, is left out and
    counted).  Prints a line per config and the flash calls by shape."""
    total = dict.fromkeys(WRAPPERS, 0)
    runs = []
    with FlashTally() as tally:
        for cell in FAMILY_CELLS:
            r = family_run(dev, *cell)
            for k in total:
                total[k] += r["launches"][k]
            runs.append(r)

            def cmp(d, what):
                s = f"{what} {d['err']:.4g}"
                if "own_err" in d:
                    s += (f" with the fused routing pinned (on its own "
                          f"routing {d['own_err']:.4g} over {d['own_rows']} "
                          f"rows whose last token kept its experts; "
                          f"{d['flips']} tokens routed otherwise, "
                          f"{d['near']} router near-ties)")
                elif "of" in d and (d["flips"] or d["near"]):
                    s += (f" ({d['rows']} of {d['of']} positions compared, "
                          f"{d['flips']} tokens routed otherwise left out, "
                          f"{d['near']} router near-ties)")
                return s
            print(f"[17 families] {r['name']} ({r['layers']} layers, "
                  f"{r['params']} fp32 params, {r['redrawn']} zero/one "
                  f"leaves redrawn): init {r['init_s']:.3f} s; "
                  f"greedy_generate of {FAMILY_STEPS} tokens {r['gen_s']:.3f} "
                  f"s, {r['flash']} flash launches; prefill "
                  f"{r['prefill_s']:.3f} s; decode {r['decode_ms']:.3f} "
                  f"ms/step; peak {r['peak_gib']:.2f} GiB; max abs error: "
                  + "; ".join([
                      cmp(r["bf16_chain"], "fused vs chain bf16"),
                      cmp(r["fp32_chain"], "fp32"),
                      cmp(r["bf16_decode"], "decode vs forward bf16"),
                      cmp(r["fp32_decode"], "fp32")])
                  + f" (bounds {FAMILY_TOL[r['name']]} abs + rel bf16; "
                  f"{LM_TOL_FP32} abs + rel, "
                  f"{FAMILY_DECODE_TOL_FP32[r['name']]} abs fp32)",
                  flush=True)
    check(sum(tally.shapes.values()) == total["flash_attention"],
          f"phase 17 counted {total['flash_attention']} flash launches, "
          f"its calls {sum(tally.shapes.values())}")
    shapes = sorted(tally.shapes.items(), key=lambda kv: -kv[1])
    print(f"[17 families] {total['flash_attention']} flash calls, by (q "
          "shape, k shape, causal, window, dtype): "
          + "; ".join(f"{k}: {n}" for k, n in shapes), flush=True)
    return dict(launches=total, runs=runs)


# phase 18: qwen2.5-3b trained over a (data 2, model 2) mesh in four
# processes on the one card (a gloo group; NCCL refuses two ranks on one
# GPU), against the same steps in this process
MESH_WORLD = 4
MESH_SHAPE, MESH_ELASTIC = (2, 2), (4, 1)
MESH_LAYERS = 2             # of qwen2.5-3b's 36: the cut
MESH_STEPS, MESH_MB = 2, 2
MESH_BATCH, MESH_SEQ = 4, 2048
MESH_TIMEOUT_S = 600
MESH_DEVICE = "cuda"        # the card the ranks share (device 0)
# the c10d collectives DTensor's redistributions come down to; the mesh
# runs fail if DTensor asks for a Shard(i) -> Shard(j) all-to-all (its
# own functional op, which the path never needs)
MESH_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "broadcast", "all_to_all_single")
# (c) bounds on the mesh run against this process's run from the same
# state and batches: relative error of each step's loss and grad norm,
# and the relative L2 error of every parameter after the last step
# (``attn.bk`` aside: its gradient is 0 in exact arithmetic, the
# softmax dropping a constant shift of a query's scores, so its AdamW
# update is rounding noise scaled to the step: within 2 * lr * steps
# absolute).  The first run on an H100 (4 layers, PR 23) read 7.73e-8, 0 and 6.6e-5 (a
# q bias) in fp32, 2.78e-5, 1.32e-4 and 0.0931 (a q bias) in bf16; the
# bounds are about ten times the fp32 readings and twice the bf16 ones.
# The planted fault (the data-axis gradient all-reduce skipped: each
# data rank steps on its half of the batch) read 0.298 on the grad norm
# of its first step; it must read MESH_FAULT_MIN times the fp32 bound
MESH_TOL = {"float32": dict(loss=1e-6, grad_norm=1e-6, param=1e-3),
            "bfloat16": dict(loss=1e-4, grad_norm=5e-4, param=0.2)}
MESH_FAULT_MIN = 1e4
# phase 18's MoE case: phi3.5-moe at full width, MESH_MOE_LAYERS of its
# 32 layers (the card's memory: four ranks of 8 of the 16 experts and
# their AdamW moments, ~9.4 GB a rank, beside this process's one-process
# run of 1.56B parameters), experts over "model" by the default rules,
# fp32 compute, one step of the dense case's tokens in one microbatch
# (the aux loss is a step metric only then), held to MESH_TOL's fp32
# bounds (aux to the loss's).  The planted fault (the load-balance loss
# from each rank's own means, one forward pass) must read
# MESH_MOE_FAULT_MIN times the aux bound
MESH_MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MESH_MOE_LAYERS = 1
MESH_MOE_FAULT_MIN = 10
# phase 18's moe-serve case: qwen3-moe-235b-a22b at full width (D 4096,
# 128 experts, top 8, expert d_ff 1536, 64/4 heads, vocab 151936),
# MESH_SERVE_LAYERS of its 94 layers (one layer's experts are 2.4B
# parameters), served over the MESH_SHAPE mesh under MOE_SERVE_RULES:
# each data rank holds 64 of the experts, each model rank half of every
# expert's FFN width, of the heads and of the vocabulary.  fp32 weights
# and compute, seed 0; the ranks build the model whole one at a time
# (~25 GB) and keep their shards (~7.4 GB).  Greedy decoding of
# MESH_SERVE_BATCH x MESH_SEQ tokens (a row a data rank: the tokens
# travel to their experts by all-to-all), MESH_SERVE_STEPS steps, and of
# the first row alone (no token moves), against this process's run of
# the same model and tokens: the largest absolute error of the prefill's
# logits and of every step's within MESH_SERVE_TOL, and the same tokens.
# The first fp32 readings on an H100 80GB HBM3 at 700 W were 3.29e-5 on
# the prefill's logits and 1.00e-3-1.42e-3 on the steps' (the first row
# alone, which moves no token: 2.41e-5 and 7.0e-4-1.17e-3; the steps
# read the bf16 KV cache, where a few of the mesh prefill's keys and
# values round the other way), past the 1e-3 on every logit first set
# for them; the bounds were then set to about ten times these readings.
# The planted fault (the dispatch all-to-all skipped: each rank's
# experts see only its own rows) read 2.48 on the prefill's logits; it
# must read MESH_SERVE_FAULT_MIN times the prefill's bound
MESH_SERVE_ARCH = "qwen3-moe-235b-a22b"
MESH_SERVE_LAYERS = 2
MESH_SERVE_BATCH, MESH_SERVE_STEPS = 2, 4
MESH_SERVE_TOL = dict(prefill=3e-4, step=1.5e-2)
MESH_SERVE_FAULT_MIN = 100


def mesh_cfg(dtype: str):
    return dataclasses.replace(get_arch(LM_ARCH), n_layers=MESH_LAYERS,
                               dtype_compute=dtype)


def mesh_moe_cfg():
    return dataclasses.replace(get_arch(MESH_MOE_ARCH),
                               n_layers=MESH_MOE_LAYERS,
                               dtype_compute="float32")


def mesh_serve_cfg():
    return dataclasses.replace(get_arch(MESH_SERVE_ARCH),
                               n_layers=MESH_SERVE_LAYERS,
                               dtype_compute="float32")


def serve_tokens(cfg) -> np.ndarray:
    """The moe-serve case's prompts, (MESH_SERVE_BATCH, MESH_SEQ)."""
    return batch_at(DataConfig(vocab=cfg.vocab, seq_len=MESH_SEQ,
                               global_batch=MESH_SERVE_BATCH, seed=SEED),
                    0)["tokens"]


def serve_greedy(model, tokens: np.ndarray, steps: int, mesh=None) -> dict:
    """``greedy_logits`` of ``tokens`` (B, T) and ``steps`` decode steps,
    over ``mesh`` when given, call by call: the prefill's and every
    step's logits (1 + steps, B, V) on the host, the tokens (B, 1 +
    steps), each call's seconds and the bytes ``moe.all_to_all``
    received on this rank in each."""
    toks = torch.from_numpy(tokens).long().to(model.device)
    out = dict(logits=[], seconds=[], a2a=[])
    with torch.no_grad(), model.spmd():
        calls = greedy_logits(model, {"tokens": toks}, steps, mesh)
        while True:
            torch.cuda.synchronize()
            t0, b0 = time.perf_counter(), moe_mod.exchanged_bytes
            logits = next(calls, None)
            if logits is None:
                break
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["a2a"].append(moe_mod.exchanged_bytes - b0)
            out["logits"].append(host(logits))
    out["logits"] = np.stack(out["logits"])
    out["tokens"] = out["logits"].argmax(-1).T.tolist()
    return out


def mesh_serve_reference(dev, work: Path) -> dict:
    """Phase 18's moe-serve case in this process: the greedy runs of the
    batch and of its first row; their logits go to ``work``."""
    model = Model(mesh_serve_cfg())
    tokens = serve_tokens(model.cfg)
    out = {}
    for key, rows in (("serve", tokens), ("serve_one", tokens[:1])):
        rec = serve_greedy(model, rows, MESH_SERVE_STEPS)
        np.save(work / f"ref_{key}.npy", rec.pop("logits"))
        out[key] = rec
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_serve_dryrun(mesh) -> dict:
    """The moe-serve case on a fake group's ``mesh``: ``run_cell``'s
    memory record of its prefill (bf16 parameters, as the dry-run serves)
    and the cost probe's all-to-all bytes a rank of its prefill and of a
    decode step (the case's fp32 compute)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.sharding.rules import MOE_SERVE_RULES
    cfg = mesh_serve_cfg()
    prefill = ShapeCase("serve", "prefill", MESH_SEQ, MESH_SERVE_BATCH)
    decode = ShapeCase("serve", "decode", MESH_SEQ + MESH_SERVE_STEPS,
                       MESH_SERVE_BATCH)
    out = dict(memory=dryrun.run_cell(cfg, prefill, mesh,
                                      srules=MOE_SERVE_RULES))
    for key, case in (("prefill", prefill), ("decode", decode)):
        out[key] = costprobe.cell_costs(
            cfg, case, mesh, srules=MOE_SERVE_RULES)["coll_all-to-all"]
    return out


def mesh_batches(cfg, n: int) -> list:
    data = DataConfig(vocab=cfg.vocab, seq_len=MESH_SEQ,
                      global_batch=MESH_BATCH, seed=SEED)
    return [batch_at(data, s) for s in range(n)]


def mesh_reference(dev, work: Path) -> dict:
    """Phase 18 (b): MESH_STEPS steps of ``make_train_step`` without a
    mesh, per compute dtype; each step's loss and grad norm, and the
    parameters after the last written to ``work/ref_<dtype>/``."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = mesh_cfg(dtype)
        model = Model(cfg)
        step = make_train_step(model, TrainConfig(microbatches=MESH_MB,
                                                  opt=TRAIN_OPT))
        state = init_train_state(model)
        rec = dict(loss=[], grad_norm=[], seconds=[])
        for batch in mesh_batches(cfg, MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            rec["loss"].append(float(metrics["loss"]))
            rec["grad_norm"].append(float(metrics["grad_norm"]))
            rec["seconds"].append(time.perf_counter() - t0)
        ref = work / f"ref_{dtype}"
        ref.mkdir()
        for name, p in state["params"].items():
            np.save(ref / f"{name}.npy", host(p.detach()))
        out[dtype] = rec
        del model, step, state
        gc.collect()
        torch.cuda.empty_cache()
    # the MoE case: one step in one microbatch, its aux kept
    model = Model(mesh_moe_cfg())
    step = make_train_step(model, TrainConfig(microbatches=1,
                                              opt=TRAIN_OPT))
    state = init_train_state(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, mesh_batches(model.cfg, 1)[0])
    out["moe"] = dict(loss=[float(metrics["loss"])],
                      grad_norm=[float(metrics["grad_norm"])],
                      aux=[float(metrics["aux"])],
                      seconds=[time.perf_counter() - t0])
    ref = work / "ref_moe"
    ref.mkdir()
    for name, p in state["params"].items():
        np.save(ref / f"{name}.npy", host(p.detach()))
    del model, step, state
    gc.collect()
    torch.cuda.empty_cache()
    out.update(mesh_serve_reference(dev, work))
    return out


def mesh_dryrun() -> dict:
    """Phase 18 (e), the dry-run's side: the (config, mesh, rules) of the
    mesh run on a fake group of MESH_WORLD ranks (one run for both
    compute dtypes: the parameters and moments are fp32 in both, and the
    dry-run's peaks of the two read alike), of the MoE case and of the
    moe-serve case (:func:`mesh_serve_dryrun`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCase
    dryrun.fake_group(MESH_WORLD)
    try:
        mesh = init_device_mesh("cpu", MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
        case = ShapeCase("mesh", "train", MESH_SEQ, MESH_BATCH)
        dense = dryrun.run_cell(mesh_cfg("float32"), case, mesh,
                                microbatches=MESH_MB, fsdp="tp")
        return {"float32": dense, "bfloat16": dense,
                "moe": dryrun.run_cell(mesh_moe_cfg(), case, mesh,
                                       microbatches=1, fsdp="tp"),
                "serve": mesh_serve_dryrun(mesh)}
    finally:
        dist.destroy_process_group()


def skip_data_reduction(grads, params):
    """The planted fault of phase 18 (c): each gradient's partial sum over
    the data axis kept as this rank's own, not all-reduced."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    out = []
    for g, p in zip(grads, params):
        names = g.device_mesh.mesh_dim_names
        where = [Replicate() if n == "data" and isinstance(pl, Partial)
                 else pl for n, pl in zip(names, g.placements)]
        g = DTensor.from_local(g.to_local(), g.device_mesh, where,
                               run_check=False)
        out.append(g.redistribute(p.device_mesh, p.placements))
    return out


def requested_bytes() -> int:
    """The bytes the CUDA caching allocator was asked for and holds now
    (``memory_allocated()`` counts its blocks: each request rounded up
    to 512 bytes, and a large one whole 2 MiB-rounded segment when the
    rest would be 1 MiB or less)."""
    return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)


def mesh_param_errors(state, ref: Path, rank: int) -> dict:
    """Every parameter's relative L2 error against the reference's (on
    rank 0; every rank takes part in the gathers), and the largest
    absolute one of ``attn.bk``."""
    errs, bk = {}, 0.0
    for name, p in state["params"].items():
        full = p.detach().full_tensor()
        if rank:
            continue
        want = torch.from_numpy(np.load(ref / f"{name}.npy")).to(full.device)
        if name.endswith("attn.bk"):
            bk = max(bk, float((full - want).abs().max()))
            continue
        errs[name] = float((full - want).norm() / want.norm())
    return dict(errs=errs, bk=bk)


def shard_param_errors(state, ref: Path) -> dict:
    """Every parameter's relative L2 error against the reference's, each
    rank on its own shard (its slice of the saved tensor, nothing
    gathered), the squared sums all-reduced over the ranks: every shard
    is held by as many ranks, so the ratio is the whole tensor's."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    names, sums = [], []
    for name, p in state["params"].items():
        want = torch.from_numpy(np.load(ref / f"{name}.npy")).to(p.device)
        want = distribute_tensor(want, p.device_mesh, p.placements,
                                 src_data_rank=None).to_local()
        got = p.detach().to_local()
        sums.append(torch.stack([((got - want) ** 2).sum(),
                                 (want ** 2).sum()]))
        names.append(name)
        del want
    total = torch.stack(sums)
    dist.all_reduce(total)
    return dict(errs={n: float((t[0] / t[1]).sqrt())
                      for n, t in zip(names, total)})


def gloo_cuda_all_gather(real):
    """``real`` (a functional all-gather: tensor, gather dim, group, tag)
    with a CUDA tensor of a gloo group gathered by c10d's
    ``all_gather_into_tensor`` instead; anything else goes to ``real``.
    Phase 18's ranks share one card, so they share a gloo group (NCCL
    takes one rank a card); gloo runs each c10d collective on CUDA
    tensors, but PyTorch 2.11's functional all-gather (which DTensor's
    redistributions call) crashes the process on a CUDA tensor of a gloo
    group (a segmentation fault in ``wait_tensor``; PERF.md)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._C._distributed_c10d import _resolve_process_group

    def gather(self, gather_dim, group, tag=""):
        if not self.is_cuda:
            return real(self, gather_dim, group, tag)
        pg = _resolve_process_group(funcol._resolve_group_name(group, tag))
        if dist.get_backend(pg) != "gloo":
            return real(self, gather_dim, group, tag)
        n, x = pg.size(), self.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        if gather_dim != 0:
            out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
        return out
    return gather


def route_gloo_cuda_gathers() -> None:
    """The functional all-gathers of this process through
    :func:`gloo_cuda_all_gather` (phase 18's ranks, before any DTensor)."""
    import torch.distributed._functional_collectives as funcol
    for name in ("all_gather_single", "all_gather_tensor"):
        real = getattr(funcol, name, None)
        if real is not None:
            setattr(funcol, name, gloo_cuda_all_gather(real))


def mesh_probe(dev) -> dict:
    """Phase 18 (a): every collective DTensor may call, on CUDA tensors of
    this gloo group, each result checked: c10d's MESH_COLLECTIVES, and
    the functional all-reduce, reduce-scatter and all-gather that
    DTensor's redistributions call (the all-gather as this process routes
    it, :func:`route_gloo_cuda_gathers`)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    rank, world = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    n = 8 * world
    base = torch.arange(n, dtype=torch.float32, device=dev)
    x = base + rank
    total = base * world + sum(range(world))
    gathered = torch.cat([base + r for r in range(world)])
    mine = slice(8 * rank, 8 * rank + 8)

    def wait(t):
        return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t

    def c10d(name):
        if name == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return y, total
        if name == "all_gather_into_tensor":
            y = torch.empty(n * world, device=dev)
            dist.all_gather_into_tensor(y, x)
            return y, gathered
        if name == "reduce_scatter_tensor":
            y = torch.empty(8, device=dev)
            dist.reduce_scatter_tensor(y, x)
            return y, total[mine]
        if name == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            return y, base
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y, torch.cat([base[mine] + r for r in range(world)])

    calls = {name: (lambda name=name: c10d(name)) for name in MESH_COLLECTIVES}
    calls["functional all_reduce"] = lambda: (
        wait(funcol.all_reduce(x, "sum", group)), total)
    calls["functional reduce_scatter"] = lambda: (
        wait(funcol.reduce_scatter_tensor(x, "sum", 0, group)), total[mine])
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    calls["functional all_gather (routed)"] = lambda: (
        wait(gather(x, 0, group)), gathered)
    out = {}
    for name, call in calls.items():
        print(f"[18 mesh] rank {rank}: {name}", flush=True)
        got, want = call()
        torch.cuda.synchronize()
        out[name] = bool(torch.equal(got, want))
    return out


def mesh_worker(rank: int, world: int, work: str) -> int:
    """One rank of phase 18 (``chip_smoke.py --mesh-worker RANK WORLD
    DIR``), on card 0 in a gloo group, doing what ``DIR/case.json``
    says: ``train`` (the probe, then the mesh runs: fp32 and bf16
    compute, and the planted fault; the fp32 run saves a checkpoint
    after its last step and takes one more; then the MoE case and the
    moe-serve case) or
    ``elastic`` (a fresh set of processes restores that checkpoint onto
    MESH_ELASTIC and takes the one more step).  Writes
    DIR/<mode><R>.json; a crash prints its Python stack
    (faulthandler)."""
    import faulthandler
    import torch.distributed as dist
    import torch.distributed.tensor._collective_utils as dtensor_comm
    import torch.distributed.tensor.placement_types as dtensor_places
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import constrain_batch
    from repro_torch.train import train_step as ts
    faulthandler.enable()
    torch.cuda.set_device(0)
    dev = torch.device(MESH_DEVICE)
    work = Path(work)
    mode = json.loads((work / "case.json").read_text())["mode"]
    dist.init_process_group("gloo", init_method=f"file://{work / mode}",
                            rank=rank, world_size=world)
    res = dict(rank=rank)

    def no_alltoall(*a, **k):
        raise RuntimeError("phase 18: DTensor asked for an all-to-all")
    dtensor_comm.shard_dim_alltoall = no_alltoall
    dtensor_places.shard_dim_alltoall = no_alltoall
    cudalib.load()
    ckpt = CheckpointManager(str(work / "ckpt"), async_save=False)
    batches = mesh_batches(mesh_cfg("float32"), MESH_STEPS + 1)

    def run(mesh, state, steps, mb):
        """Take ``steps`` on ``state`` (``{"model", "state"}``; the state
        is replaced by the stepped one): each step's loss, grad norm and
        seconds, the flash launches and the peak."""
        step = ts.make_train_step(state["model"], TrainConfig(
            microbatches=mb, opt=TRAIN_OPT), mesh)
        st = state["state"]
        rec = dict(loss=[], grad_norm=[], seconds=[])
        torch.cuda.reset_peak_memory_stats()
        flash_cuda.launches = 0
        for batch in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, metrics = step(st, batch)
            rec["loss"].append(float(metrics["loss"]))
            rec["grad_norm"].append(float(metrics["grad_norm"]))
            if "aux" in metrics:
                rec.setdefault("aux", []).append(float(metrics["aux"]))
            rec["seconds"].append(time.perf_counter() - t0)
        rec["launches"] = flash_cuda.launches
        rec["peak"] = torch.cuda.max_memory_allocated()
        state["state"] = st
        return rec

    def finish() -> int:
        (work / f"{mode}{rank}.json").write_text(json.dumps(res))
        dist.barrier()
        dist.destroy_process_group()
        return 0

    route_gloo_cuda_gathers()
    if mode == "elastic":
        res["elastic"] = mesh_elastic_run(rank, ckpt, work, batches, run)
        return finish()
    mesh = make_local_mesh(MESH_SHAPE[1])
    res["probe"] = mesh_probe(dev)
    # a smoke-size state placed and freed first: the process's first
    # placement also frees a few hundred bytes it held (640 on an
    # H100), which the byte count of (e) must not see
    init_train_state(Model(get_arch(LM_ARCH).smoke()), mesh)
    for label, dtype in (("float32", "float32"),
                         ("bfloat16", "bfloat16"),
                         ("fault", "float32")):
        print(f"[18 mesh] rank {rank}: {label} run", flush=True)
        gc.collect()        # the probe's tensors, a run's leftovers
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        asked = requested_bytes()
        model = Model(mesh_cfg(dtype))
        st = init_train_state(model, mesh)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        asked = requested_bytes() - asked
        leaves = (list(st["params"].values())
                  + [t for k in ("m", "v")
                     for t in st["opt"][k].values()]
                  + [st["opt"]["step"]])
        placed = [constrain_batch(torch.from_numpy(v).to(dev), mesh)
                  for v in batches[0].values()]
        rec = dict(held=held, asked=asked,
                   state_bytes=sum(local_bytes(t) for t in leaves),
                   batch_bytes=sum(local_bytes(t) for t in placed))
        del placed, leaves
        holder = dict(model=model, state=st)
        del st
        real = ts.reduce_grads
        if label == "fault":
            ts.reduce_grads = skip_data_reduction
        steps = 1 if label == "fault" else MESH_STEPS
        try:
            rec.update(run(mesh, holder, batches[:steps], MESH_MB))
        finally:
            ts.reduce_grads = real
        rec["peak"] -= base
        if label != "fault":
            rec.update(mesh_param_errors(holder["state"], work /
                                         f"ref_{dtype}", rank))
        if label == "float32":
            ckpt.save(MESH_STEPS, holder["state"])
            rec["straight"] = run(mesh, holder,
                                  batches[MESH_STEPS:], MESH_MB)
        res[label] = rec
        del model, holder
        gc.collect()
        torch.cuda.empty_cache()
    res["moe"] = mesh_moe_run(rank, mesh, dev, work, run)
    res["serve"] = mesh_serve_run(rank, mesh, work)
    return finish()


def mesh_elastic_run(rank: int, ckpt, work: Path, batches, run) -> dict:
    """Phase 18 (f) on one rank of a fresh set of processes (``run`` is
    the worker's step runner): the fp32 run's checkpoint (rank 0 of the
    train processes wrote it) restored onto a MESH_ELASTIC mesh, rank 0
    holding the restored parameters against the saved arrays, and the
    one more step."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.elastic import restore_for_mesh
    mesh = make_local_mesh(MESH_ELASTIC[1])
    model = Model(mesh_cfg("float32"))
    at, st, _ = restore_for_mesh(ckpt, model, mesh)
    el = dict(restored_at=at)
    if rank == 0:
        with np.load(work / "ckpt" / f"step_{at:010d}" /
                     "arrays.npz") as saved:
            el["bit_equal"] = all(
                np.array_equal(host(p.detach().full_tensor()),
                               saved[f"params||{name}"])
                for name, p in st["params"].items())
    holder = dict(model=model, state=st)
    del st
    # MESH_ELASTIC's data axis of 4 leaves each rank one of the 4 rows:
    # one microbatch
    el["step"] = run(mesh, holder, batches[MESH_STEPS:], 1)
    el["placements"] = sorted({str(p.placements) for p in
                               holder["state"]["params"].values()})
    return el


def mesh_moe_run(rank: int, mesh, dev, work: Path, run) -> dict:
    """Phase 18's MoE case on one rank (``run`` is the worker's step
    runner): the placed state's bytes, the planted fault's aux (one
    forward pass from the initial parameters), then one step and the
    parameters' errors against the one-process run's."""
    from repro_torch.launch.dryrun import local_bytes
    from repro_torch.sharding.rules import constrain_batch
    # the planted fault, the same one the CPU test's ranks plant
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_mesh import local_mean_aux
    print(f"[18 mesh] rank {rank}: moe run", flush=True)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    asked = requested_bytes()
    model = Model(mesh_moe_cfg())
    st = init_train_state(model, mesh)
    torch.cuda.synchronize()
    asked = requested_bytes() - asked
    leaves = (list(st["params"].values())
              + [t for k in ("m", "v") for t in st["opt"][k].values()]
              + [st["opt"]["step"]])
    batch = mesh_batches(model.cfg, 1)[0]
    placed = {k: constrain_batch(torch.from_numpy(v).to(dev), mesh)
              for k, v in batch.items()}
    rec = dict(asked=asked,
               state_bytes=sum(local_bytes(t) for t in leaves),
               batch_bytes=sum(local_bytes(t) for t in placed.values()),
               placements=str(st["params"]["blocks.0.moe.wi"].placements))
    real = moe_mod.balance_loss
    moe_mod.balance_loss = local_mean_aux
    try:
        with torch.no_grad(), model.spmd():
            _, metrics = model.loss(placed)
        rec["fault_aux"] = float(metrics["aux"].full_tensor())
    finally:
        moe_mod.balance_loss = real
    del leaves, placed, metrics
    holder = dict(model=model, state=st)
    del st
    rec.update(run(mesh, holder, [batch], 1))
    rec["peak"] -= base
    rec.update(shard_param_errors(holder["state"], work / "ref_moe"))
    del model, holder
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def skip_dispatch(real):
    """The planted fault of the moe-serve case: ``moe.all_to_all`` with
    every dispatch exchange (each layer's first; the second brings the
    results back) skipped, each rank keeping its own rows' slots for its
    own experts and receiving nothing: its experts see only its rows."""
    calls = [0]

    def exchange(x, group):
        calls[0] += 1
        if calls[0] % 2 == 0:
            return real(x, group)
        out = torch.zeros_like(x)
        me = group.rank()
        out[me] = x[me]
        return out
    return exchange


def mesh_serve_run(rank: int, mesh, work: Path) -> dict:
    """Phase 18's moe-serve case on one rank: the seed-0 model built
    whole by one rank at a time and placed by MOE_SERVE_RULES
    (``dryrun.param_shardings``), its shards' bytes, the greedy runs of
    the batch and of its first row (rank 0 holding the logits against
    this process's), the flash launches, and the planted fault's
    prefill."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import local_bytes, param_shardings
    from repro_torch.sharding.rules import MOE_SERVE_RULES
    from repro_torch.train.train_step import place_parameters
    print(f"[18 mesh] rank {rank}: moe-serve run", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = mesh_serve_cfg()
    for r in range(dist.get_world_size()):
        if r == rank:
            model = Model(cfg)
            params = place_parameters(model, param_shardings(
                model, mesh, MOE_SERVE_RULES))
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    rec = dict(state_bytes=sum(local_bytes(p) for p in params.values()),
               placements=str(params["blocks.0.moe.wi"].placements))
    del params
    tokens = serve_tokens(cfg)
    flash_cuda.launches = 0
    for key, rows in (("serve", tokens), ("serve_one", tokens[:1])):
        got = serve_greedy(model, rows, MESH_SERVE_STEPS, mesh)
        logits = got.pop("logits")
        if rank == 0:
            want = np.load(work / f"ref_{key}.npy")
            got["err"] = [float(np.abs(a - b).max())
                          for a, b in zip(logits, want)]
        rec[key] = got
    rec["launches"] = flash_cuda.launches
    real = moe_mod.all_to_all
    moe_mod.all_to_all = skip_dispatch(real)
    try:
        logits = serve_greedy(model, tokens, 0, mesh)["logits"][0]
    finally:
        moe_mod.all_to_all = real
    rec["fault_launches"] = flash_cuda.launches - rec["launches"]
    if rank == 0:
        want = np.load(work / "ref_serve.npy")[0]
        rec["fault_err"] = float(np.abs(logits - want).max())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_workers(work: Path, mode: str) -> tuple:
    """Start MESH_WORLD ranks of ``mode``; (their results or None, exit
    codes, output tails, seconds)."""
    (work / "case.json").write_text(json.dumps({"mode": mode}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
         str(r), str(MESH_WORLD), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(MESH_WORLD)]
    try:
        outs = [p.communicate(timeout=MESH_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    files = [work / f"{mode}{r}.json" for r in range(MESH_WORLD)]
    res = [json.loads(f.read_text()) if f.exists() else None for f in files]
    return res, [p.returncode for p in procs], outs, \
        time.perf_counter() - t0


def mesh_serve_check(ref: dict, dry: dict, res: list) -> tuple:
    """Phase 18's moe-serve case against this process's run (``ref``) and
    the fake group's (``dry``, :func:`mesh_serve_dryrun`), every rank's
    record in ``res``: (the line to print, the flash launches of every
    rank)."""
    s0 = res[0]["serve"]
    mem = dry["memory"]
    params = mem["argument_bytes"] - mem["batch_bytes"]
    for r in res:
        got = r["serve"]
        check(got["launches"] == 2 * MESH_SERVE_LAYERS
              and got["fault_launches"] == MESH_SERVE_LAYERS,
              f"(d) moe-serve rank {r['rank']}: {got['launches']} flash "
              f"launches in two prefills and their decode steps, "
              f"{got['fault_launches']} in the fault's prefill")
        check(got["state_bytes"] == 2 * params,
              f"(e) moe-serve rank {r['rank']}: {got['state_bytes']} B of "
              f"fp32 shards, not twice the dry-run's bf16 {params} B")
        a2a = got["serve"]["a2a"]
        check(a2a[0] == dry["prefill"] > 0
              and all(b == dry["decode"] > 0 for b in a2a[1:])
              and not any(got["serve_one"]["a2a"]),
              f"moe-serve rank {r['rank']}: all-to-all bytes {a2a} (the "
              f"first row alone {got['serve_one']['a2a']}), the cost "
              f"probe's {dry['prefill']} a prefill, {dry['decode']} a "
              f"step")
        for key in ("serve", "serve_one"):
            check(got[key]["tokens"] == ref[key]["tokens"],
                  f"(c) moe-serve {key} rank {r['rank']}: tokens "
                  f"{got[key]['tokens']}, one process {ref[key]['tokens']}")
    tol = MESH_SERVE_TOL
    for key in ("serve", "serve_one"):
        err = s0[key]["err"]
        check(err[0] <= tol["prefill"] and max(err[1:]) <= tol["step"],
              f"(c) moe-serve {key}: logits' largest absolute errors "
              f"{err} (prefill, then each step) past {tol}")
    check(s0["fault_err"] >= MESH_SERVE_FAULT_MIN * tol["prefill"],
          f"(c) moe-serve: the planted fault (dispatch skipped) reads only "
          f"{s0['fault_err']} on the prefill's logits")

    def ms(sec):
        return f"{statistics.median(sec) * 1e3:.1f}"
    line = (
        f"moe-serve ({MESH_SERVE_ARCH} full width, {MESH_SERVE_LAYERS} of "
        f"94 layers, MOE_SERVE_RULES, experts {s0['placements']}, fp32, "
        f"{MESH_SERVE_BATCH} x {MESH_SEQ} tokens + {MESH_SERVE_STEPS} "
        f"greedy steps): logits' largest abs error {s0['serve']['err']} "
        f"(prefill, steps), the first row alone {s0['serve_one']['err']} "
        f"(bounds {tol}), tokens = one process's on every rank; "
        f"all-to-all bytes a rank: prefill {s0['serve']['a2a'][0]}, step "
        f"{s0['serve']['a2a'][1]} (cost probe, fake group: "
        f"{dry['prefill']}, {dry['decode']}), the first row alone 0; "
        f"planted fault (dispatch skipped) {s0['fault_err']:.4g} "
        f"({s0['fault_err'] / tol['prefill']:.3g} times the prefill's "
        f"bound); gloo "
        f"on one card (not the deployment's speed): prefill s "
        f"{s0['serve']['seconds'][0]:.3f} (one process "
        f"{ref['serve']['seconds'][0]:.3f}), decode ms a step "
        f"{ms(s0['serve']['seconds'][1:])} (one process "
        f"{ms(ref['serve']['seconds'][1:])}), the first row alone "
        f"{s0['serve_one']['seconds'][0]:.3f} s, "
        f"{ms(s0['serve_one']['seconds'][1:])} ms (one process "
        f"{ref['serve_one']['seconds'][0]:.3f} s, "
        f"{ms(ref['serve_one']['seconds'][1:])} ms); state bytes a rank "
        f"{s0['state_bytes']} = 2 x the dry-run's bf16 argument bytes "
        f"less the batch's ({params}); flash launches a rank "
        f"{s0['launches']} (+{s0['fault_launches']} in the fault's "
        f"prefill)")
    return line, sum(r["serve"]["launches"] + r["serve"]["fault_launches"]
                     for r in res)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def mesh_phase(dev) -> dict:
    """Phase 18: qwen2.5-3b at full width, MESH_LAYERS layers, trained over
    a MESH_SHAPE (data, model) mesh in MESH_WORLD processes on the one
    card: (a) the collectives DTensor calls, on CUDA tensors of a gloo
    group; (b) the steps without a mesh here; (c) the mesh runs in fp32
    and bf16 compute against (b), and a planted fault; (d) each rank's
    flash launches; (e) each rank's placed state bytes against the
    dry-run's on a fake group; (f) the fp32 run's checkpoint restored
    onto MESH_ELASTIC by a fresh set of processes, bit for bit, its next
    step against the straight run's; and the MoE case (MESH_MOE_ARCH at
    full width, MESH_MOE_LAYERS layers, experts over "model"): one step
    against one process (loss, aux, grad norm, parameters), each rank's
    state bytes against the dry-run's, its flash launches, and a planted
    fault in the aux; and the moe-serve case (MESH_SERVE_ARCH at full
    width under MOE_SERVE_RULES, :func:`mesh_serve_check`)."""
    t_phase = time.perf_counter()
    work = ROOT / "build" / f"chip_smoke_mesh_{int(time.time() * 1e3)}"
    work.mkdir(parents=True)
    try:
        ref = mesh_reference(dev, work)
        t_ref = time.perf_counter() - t_phase
        dry = mesh_dryrun()
        t_dry = time.perf_counter() - t_phase - t_ref
        res, rcs, outs, train_s = mesh_workers(work, "train")
        for r, (rc, o) in enumerate(zip(rcs, outs)):
            check(rc == 0, f"mesh rank {r} exited {rc}:\n{o[-6000:]}")
        el, rcs, outs, elastic_s = mesh_workers(work, "elastic")
        for r, (rc, o) in enumerate(zip(rcs, outs)):
            check(rc == 0, f"elastic rank {r} exited {rc}:\n{o[-4000:]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in res:
        check(all(r["probe"].values()),
              f"(a) rank {r['rank']}: a collective gave a wrong result on "
              f"CUDA tensors of the gloo group: {r['probe']}")
    want_launches = MESH_LAYERS * MESH_MB * 2 * MESH_STEPS
    lines = []
    for label in ("float32", "bfloat16"):
        tol = MESH_TOL[label]
        want = ref[label]
        for r in res:
            got = r[label]
            check(got["launches"] == want_launches,
                  f"(d) {label} rank {r['rank']}: {got['launches']} flash "
                  f"launches, not {want_launches}")
            state_bytes = dry[label]["argument_bytes"] \
                - dry[label]["batch_bytes"]
            check(got["asked"] == got["state_bytes"] == state_bytes
                  and got["batch_bytes"] == dry[label]["batch_bytes"],
                  f"(e) {label} rank {r['rank']}: the allocator holds "
                  f"{got['asked']} B asked for the state "
                  f"({got['state_bytes']} B of shards, "
                  f"{got['held']} B of blocks), batch "
                  f"{got['batch_bytes']} B, against the dry-run's "
                  f"{dry[label]}")
            for s in range(MESH_STEPS):
                check(rel(got["loss"][s], want["loss"][s]) <= tol["loss"]
                      and rel(got["grad_norm"][s], want["grad_norm"][s])
                      <= tol["grad_norm"],
                      f"(c) {label} rank {r['rank']} step {s + 1}: loss "
                      f"{got['loss'][s]} / {want['loss'][s]}, grad norm "
                      f"{got['grad_norm'][s]} / {want['grad_norm'][s]}")
        errs = res[0][label]["errs"]
        worst = max(errs, key=errs.get)
        check(errs[worst] <= tol["param"]
              and res[0][label]["bk"] <= 2 * TRAIN_OPT.lr * MESH_STEPS,
              f"(c) {label}: parameter {worst} relative L2 error "
              f"{errs[worst]}, attn.bk {res[0][label]['bk']}")
        g = res[0][label]
        lines.append(
            f"{label}: loss {[round(x, 6) for x in g['loss']]} (one "
            f"process {[round(x, 6) for x in want['loss']]}), worst rel "
            f"loss {max(rel(a, b) for a, b in zip(g['loss'], want['loss'])):.3g}"
            f", grad norm {max(rel(a, b) for a, b in zip(g['grad_norm'], want['grad_norm'])):.3g}"
            f", param {errs[worst]:.3g} ({worst}), bk abs {g['bk']:.3g}; "
            f"step s {[round(x, 3) for x in g['seconds']]} (one process "
            f"{[round(x, 3) for x in want['seconds']]}); peak GiB a rank "
            + ", ".join(f"{r[label]['peak'] / 2 ** 30:.3f}" for r in res)
            + f" (dry-run {dry[label]['peak_bytes'] / 2 ** 30:.3f})")
    # the MoE case
    tol, want = MESH_TOL["float32"], ref["moe"]
    moe_launches = MESH_MOE_LAYERS * 1 * 2
    moe_state = dry["moe"]["argument_bytes"] - dry["moe"]["batch_bytes"]
    for r in res:
        got = r["moe"]
        check(got["launches"] == moe_launches,
              f"(d) moe rank {r['rank']}: {got['launches']} flash launches, "
              f"not {moe_launches}")
        check(got["asked"] == got["state_bytes"] == moe_state
              and got["batch_bytes"] == dry["moe"]["batch_bytes"],
              f"(e) moe rank {r['rank']}: the allocator holds "
              f"{got['asked']} B asked for the state ({got['state_bytes']} "
              f"B of shards), batch {got['batch_bytes']} B, against the "
              f"dry-run's {dry['moe']}")
        check(rel(got["loss"][0], want["loss"][0]) <= tol["loss"]
              and rel(got["aux"][0], want["aux"][0]) <= tol["loss"]
              and rel(got["grad_norm"][0], want["grad_norm"][0])
              <= tol["grad_norm"],
              f"(c) moe rank {r['rank']}: loss {got['loss']} / "
              f"{want['loss']}, aux {got['aux']} / {want['aux']}, grad "
              f"norm {got['grad_norm']} / {want['grad_norm']}")
    m0 = res[0]["moe"]
    moe_worst = max(m0["errs"], key=m0["errs"].get)
    check(m0["errs"][moe_worst] <= tol["param"],
          f"(c) moe: parameter {moe_worst} relative L2 error "
          f"{m0['errs'][moe_worst]}")
    moe_fault = rel(m0["fault_aux"], want["aux"][0])
    check(moe_fault >= MESH_MOE_FAULT_MIN * tol["loss"],
          f"(c) moe: the planted fault (aux from a rank's own means) reads "
          f"only {moe_fault} from the one-process aux")
    lines.append(
        f"moe ({MESH_MOE_ARCH}, {MESH_MOE_LAYERS} of 32 layers, experts "
        f"{m0['placements']}): loss {m0['loss'][0]:.6f} (one process "
        f"{want['loss'][0]:.6f}), rel loss "
        f"{rel(m0['loss'][0], want['loss'][0]):.3g}, aux "
        f"{rel(m0['aux'][0], want['aux'][0]):.3g} ({m0['aux'][0]:.6f}), "
        f"grad norm {rel(m0['grad_norm'][0], want['grad_norm'][0]):.3g}, "
        f"param {m0['errs'][moe_worst]:.3g} ({moe_worst}); planted fault "
        f"(aux from a rank's own means) {moe_fault:.3g} "
        f"({moe_fault / tol['loss']:.3g} times the bound); step s "
        f"{round(m0['seconds'][0], 3)} (one process "
        f"{round(want['seconds'][0], 3)}); state bytes a rank "
        f"{m0['asked']} = the dry-run's; peak GiB a rank "
        + ", ".join(f"{r['moe']['peak'] / 2 ** 30:.3f}" for r in res)
        + f" (dry-run {dry['moe']['peak_bytes'] / 2 ** 30:.3f}); flash "
        f"launches a rank {moe_launches}")
    serve_line, serve_launches = mesh_serve_check(ref, dry["serve"], res)
    lines.append(serve_line)
    fault = res[0]["fault"]
    f_gn = rel(fault["grad_norm"][0], ref["float32"]["grad_norm"][0])
    check(f_gn >= MESH_FAULT_MIN * MESH_TOL["float32"]["grad_norm"],
          f"(c) the planted fault's grad norm reads only {f_gn} from the "
          f"one-process step's")
    straight = res[0]["float32"]["straight"]
    el = [r["elastic"] for r in el]
    step3 = el[0]["step"]
    check(all(r["restored_at"] == MESH_STEPS for r in el)
          and el[0]["bit_equal"],
          "(f) the restored parameters are not the saved ones bit for bit")
    check(rel(step3["loss"][0], straight["loss"][0])
          <= MESH_TOL["float32"]["loss"]
          and rel(step3["grad_norm"][0], straight["grad_norm"][0])
          <= MESH_TOL["float32"]["grad_norm"],
          f"(f) step {MESH_STEPS + 1} after the restore: {step3} against "
          f"the straight run's {straight}")
    elastic_launches = MESH_LAYERS * 1 * 2
    for rank, r in enumerate(el):
        n = r["step"]["launches"]
        check(n == elastic_launches,
              f"(d) elastic rank {rank}: {n} flash launches, not "
              f"{elastic_launches}")
    launches = sum(r[k]["launches"] + (r[k]["straight"]["launches"]
                                       if k == "float32" else 0)
                   for r in res for k in ("float32", "bfloat16", "fault",
                                          "moe")) \
        + sum(r["step"]["launches"] for r in el) + serve_launches
    print(f"[18 mesh] {LM_ARCH} full width, {MESH_LAYERS} of 36 layers (the "
          f"cut), mesh (data, model) {MESH_SHAPE} in {MESH_WORLD} processes "
          f"on one card (gloo), {MESH_BATCH} x {MESH_SEQ} tokens, "
          f"microbatches {MESH_MB}, remat full, AdamW lr {TRAIN_OPT.lr}: "
          f"(a) collectives on CUDA tensors {res[0]['probe']}, DTensor "
          f"asked for no all-to-all; (c) " + "; ".join(lines)
          + f"; planted fault (data-axis all-reduce skipped), step 1: "
          f"grad norm {f_gn:.3g} ({f_gn / MESH_TOL['float32']['grad_norm']:.3g} "
          f"times the bound); "
          f"(d) flash launches a rank a run {want_launches} = "
          f"{MESH_LAYERS} layers x {MESH_MB} microbatches x 2 x "
          f"{MESH_STEPS} steps; (e) state bytes a rank asked of the "
          f"allocator {res[0]['float32']['asked']} = the dry-run's "
          f"argument bytes less the batch's, on every rank "
          f"(memory_allocated {res[0]['float32']['held']}: its blocks), "
          f"batch {res[0]['float32']['batch_bytes']} B apart; (f) "
          f"restored onto "
          f"{MESH_ELASTIC} {el[0]['placements']} bit for bit, step "
          f"{MESH_STEPS + 1} loss {step3['loss'][0]:.6f} (straight "
          f"{straight['loss'][0]:.6f}) in fresh processes; seconds: "
          f"reference {t_ref:.1f}, dry-run {t_dry:.1f}, mesh runs "
          f"{train_s:.1f}, elastic {elastic_s:.1f}, phase "
          f"{time.perf_counter() - t_phase:.1f}",
          flush=True)
    return {"launches": {"flash_attention": launches}}


# phase 19: the cost tools on the card.  (a) the two-point probe's FLOPs
# of phase 16 (b)'s step (its config and tokens, on meta tensors in this
# process, nothing on the card) against phase 16's live count of its
# first step (FlopCounterMode plus the flash kernel's formula) within
# COST_TOL relative; (b) the step's FLOPs over its seconds as a share of
# the card's bf16 peak; (c) the join's dry-run, rank 0 of COST_JOIN_WORLD
# of the distributed count on the card, against the same shard on the
# CPU (plain versions), for both of the reference's queries
COST_TOL = 0.01
COST_JOIN_WORLD = 256


def cost_phase(trained: dict) -> dict:
    """Phase 19 (see above); returns the kernel launches of (c)'s passes
    on the card."""
    from repro_torch.launch import dryrun_join
    from repro_torch.launch.shapes import ShapeCase
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    case = ShapeCase("phase16", "train", TRAIN_SEQ, TRAIN_BATCH)
    t0 = time.perf_counter()
    probe = costprobe.probe_costs(
        cfg, case, None, lambda c, cs, m: costprobe.cell_costs(
            c, cs, m, microbatches=1))
    probe_s = time.perf_counter() - t0
    live = trained["live"]
    err = rel(probe["flops"], live["flops"])
    check(err <= COST_TOL,
          f"(a) the probe's {probe['flops']:.6g} FLOPs against the live "
          f"count's {live['flops']:.6g} ({err:.3g} apart)")
    model_flops = roofline.model_flops(cfg, case, 1)
    peak = roofline.PEAK_FLOPS[cfg.dtype_compute]
    step_s = trained["step_s"]
    roof = roofline.from_costs(probe, cfg, case, 1)
    launches: dict = {}
    joins = {}
    reset_launches()
    for query in ("5-path", "5-cycle"):
        on_card = dryrun_join.run_join(query=query, device="cuda",
                                       world=COST_JOIN_WORLD)
        card_launches = read_launches()
        on_cpu = dryrun_join.run_join(query=query, device="cpu",
                                      world=COST_JOIN_WORLD)
        for key in ("shard_count", "shard_overflow"):
            check(on_card[key] == on_cpu[key],
                  f"(c) {query}: rank 0's {key} on the card "
                  f"{on_card[key]}, on the CPU {on_cpu[key]}")
        joins[query] = (on_card, on_cpu)
        reset_launches()
        for name, n in card_launches.items():
            launches[name] = launches.get(name, 0) + n
    check(joins["5-path"][0]["shard_count"] > 0,
          "(c) rank 0's 5-path shard counted nothing")
    check(launches["expand"] > 0,
          f"(c) the join's passes on the card launched no EXPAND kernel: "
          f"{launches}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[19 cost] (a) {LM_ARCH} train step of phase 16 (b) "
          f"({TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_MB} microbatches, "
          f"remat {cfg.remat_policy}, {cfg.dtype_compute}): probe "
          f"{probe['flops']:.6g} FLOPs (one group "
          f"{probe['probe_points']['one_group']['flops']:.6g}, two "
          f"{probe['probe_points']['two_groups']['flops']:.6g}; "
          f"{probe_s:.1f} s on the host), live count {live['flops']:.6g} "
          f"(FlopCounterMode {live['flops'] - live['kernel_flops']:.6g} + "
          f"the flash kernel's formula {live['kernel_flops']:.6g} over "
          f"{live['launches']} launches; counted step 1 "
          f"{live['seconds']:.3f} s): {err:.3g} apart (tol {COST_TOL}); "
          f"probe bytes {probe['bytes']:.6g} (unfused bound), roofline compute "
          f"{roof.compute_s:.4f} s, memory {roof.memory_s:.4f} s, dominant "
          f"{roof.dominant}; (b) on {smi}: step {step_s:.3f} s (phase 16 "
          f"(b)'s median), model FLOPs {model_flops:.6g} = "
          f"{model_flops / step_s / 1e12:.2f} TFLOP/s = "
          f"{model_flops / step_s / peak:.2%} of {peak / 1e12:.0f} TFLOP/s,"
          f" counted FLOPs {live['flops'] / step_s / 1e12:.2f} TFLOP/s = "
          f"{live['flops'] / step_s / peak:.2%}; (c) join dry-run, rank 0 of "
          f"{COST_JOIN_WORLD}: " + "; ".join(
              f"{q} count {c['shard_count']} overflow {c['shard_overflow']} "
              f"(CPU plain {u['shard_count']}, {u['shard_overflow']}), pass "
              f"{c['pass_s']} s (CPU {u['pass_s']}), peak "
              f"{c['memory']['peak_device_bytes']} B, tables "
              f"{c['memory']['table_bytes']} B, frontier chunk "
              f"{c['memory']['frontier_bytes']} B, collectives "
              f"{c['collectives']['all-reduce']} B all-reduce"
              for q, (c, u) in joins.items())
          + f"; launches on the card " + json.dumps(launches)
          + f" | phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1 card] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. the build
    cudalib.load()
    ptxas = [ln.strip() for ln in cudalib.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[2 build] nvcc sm_90a: {cudalib.build_seconds():.2f} s "
          f"({len(ptxas)} ptxas lines)", flush=True)
    for ln in ptxas:
        print(f"    {ln}")

    # the two graphs (data is made anew in every run)
    db = graph_db(zipf_graph(WIKI["nv"], WIKI["ne"], ZIPF_A, seed=SEED))
    db2 = grqc_db()

    # 3. kernels against their plain versions on the card
    rows, shape, seeded = kernels_vs_plain(db, dev)
    print(f"[3 kernels] C={C} n={shape['n']} m={shape['m']} "
          f"order={shape['order']}: " + "; ".join(
              f"{k}: {v['ms']:.4f} ms, device busy {v['busy_ms']:.4f} ms "
              f"(plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.6f} ms "
              f"by {v['bound_by']}, {v['note']})"
              for k, v in rows.items()), flush=True)
    print("[3 kernels] fold_merged on seeded inputs, bit-exact: " + "; ".join(
        f"{k}: {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} ms), stats "
        f"{v['stats']}" for k, v in seeded.items()), flush=True)
    # 14, part 1: the flash kernel against its plain version, here beside
    #    the other kernels' checks and before the long launches at 2^25
    #    rows (profiled late in the script, or after those, its launches
    #    lost most of their device records)
    rows["flash_attention"] = flash_phase(dev)
    # 3, at the static pass's capacity
    big = static_scale_rows(db2, dev)
    print("[3 kernels] at the static pass's capacity, ca-GrQc-scale "
          "graph's plan, bit-exact: " + "; ".join(
              f"{k}: {v['ms']:.4f} ms, device busy {v['busy_ms']:.4f} ms "
              f"(plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.6f} ms "
              f"by {v['bound_by']}, library {v['library_ms']} ms, "
              f"{v['note']})" for k, v in big.items()), flush=True)
    # 3, the tier-2 probe and insert at the static benchmark cell's shapes
    t2 = tier2_rows(dev)
    print("[3 kernels] tier-2 ops at the static cell's shapes, bit-exact: "
          + "; ".join(
              f"{k}: {v['ms']:.4f} ms, device busy {v['busy_ms']:.4f} ms "
              f"(plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.6f} ms "
              f"by {v['bound_by']}, {v['note']})" for k, v in t2.items()),
          flush=True)
    rows.update(t2)

    # 4. count on the wiki-Vote-scale graph (main path)
    q = cycle_query(4)
    reset_launches()
    torch.cuda.synchronize()
    res = engine.count(q, db, capacity=C)
    after_count = read_launches()
    want = cycle_oracle(db, 4)
    check(res.count == want, f"count {res.count} != scipy oracle {want}")
    cnt = res.counters
    check(cnt["expand_calls_cuda"] > 0 and cnt["expand_calls_torch"] == 0,
          "count did not run EXPAND on the CUDA kernel")
    check(after_count["expand"] == cnt["expand_calls_cuda"],
          "expand wrapper launches != executor count")
    print(f"[4 count] 4-cycle on Zipf(a={ZIPF_A}) graph, {WIKI['nv']} "
          f"vertices, {WIKI['ne']} edges drawn, "
          f"{db.relations['E'].shape[0]} distinct: count={res.count} "
          f"(oracle {want}) exec_s={res.exec_s:.3f} plan_s={res.plan_s:.3f} "
          f"compile_s={res.compile_s:.3f} counters="
          + json.dumps({k: v for k, v in cnt.items() if v}), flush=True)

    # 5. evaluate on the ca-GrQc-scale graph (main path)
    res2 = engine.evaluate(q, db2, capacity=C)
    launches = read_launches()
    after_eval = {k: launches[k] - after_count[k] for k in launches}
    rows2 = res2.tuples
    want2 = cycle_oracle(db2, 4)
    check_rows(rows2, res2.order, q, db2, want2, "evaluate")
    edges = db2.relations["E"]
    cnt2 = res2.counters
    for op in ("expand", "fold", "emit"):
        check(cnt2[f"{op}_calls_cuda"] > 0 and cnt2[f"{op}_calls_torch"] == 0,
              f"evaluate did not run {op} on the CUDA kernel")
    check(after_eval["fold_replay"] == cnt2["fold_calls_cuda"]
          and after_eval["emit"] == cnt2["emit_calls_cuda"]
          and after_eval["expand"] == cnt2["expand_calls_cuda"],
          "wrapper launches != executor counts in evaluate")
    print(f"[5 evaluate] 4-cycle on symmetric Zipf(a={ZIPF_A}) graph, "
          f"{GRQC['nv']} vertices, {GRQC['ne']} undirected edges drawn, "
          f"{edges.shape[0]} distinct directed: rows={rows2.shape[0]} "
          f"(oracle {want2}), unique, every atom holds; "
          f"exec_s={res2.exec_s:.3f} counters="
          + json.dumps({k: v for k, v in cnt2.items() if v}), flush=True)

    # 6. the main path went through every kernel
    main_path = {k: v for k, v in launches.items()
                 if k != "fold_splice"
                 and k not in STATIC_ONLY + CHAIN_ONLY + LM_ONLY}
    for name, n in main_path.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print(f"[6 launches] main path (count + evaluate): "
          + json.dumps(launches)
          + f" | total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 8. payload-replay evaluation: cold then warm on ONE engine (tier-2
    #    tables live per engine object)
    td2, order2 = engine.plan_query(q, db2)
    pay = CachedTrieJoin(q, td2, order2, db2, capacity=C,
                         cache=PAYLOAD_CACHE, device=dev)
    reset_launches()
    passes, pay_digests = [], []
    for label in ("cold", "warm"):
        before = dict(pay.stats)
        prows, secs = timed_pass(pay)
        check_rows(prows, order2, q, db2, want2, f"payload {label}")
        passes.append((label, secs, {k: pay.stats[k] - before[k]
                                     for k in PAY_KEYS}))
        pay_digests.append(digest(prows))
    pay_launches = read_launches()
    pst = pay.stats
    warm = passes[1][2]
    check(warm["tier2_replay_hits"] > 0, "warm pass served no replay hits")
    check(pay_launches["fold_splice"] == pst["fold_splice_calls_cuda"] > 0,
          f"splice launches {pay_launches['fold_splice']} != executor "
          f"count {pst['fold_splice_calls_cuda']}")
    check(pst["fold_calls_torch"] == 0 and pst["expand_calls_torch"] == 0
          and pst["emit_calls_torch"] == 0,
          "payload evaluation left the CUDA kernels")
    check(pay_launches["fold_replay"]
          == pst["fold_calls_cuda"] - pst["fold_splice_calls_cuda"]
          and pay_launches["expand"] == pst["expand_calls_cuda"]
          and pay_launches["emit"] == pst["emit_calls_cuda"],
          "wrapper launches != executor counts in payload evaluation")
    for name, n in pay_launches.items():
        check(n > 0 or name in STATIC_ONLY + CHAIN_ONLY + LM_ONLY,
              f"kernel {name} was not launched by payload evaluation")
    print(f"[8 payload] 4-cycle on the ca-GrQc-scale graph, C={C}, cache "
          f"setassoc 8-way 2^14 slots, payload_rows 2^17: rows={want2} "
          f"(oracle) both passes, unique, every atom holds; "
          + "; ".join(f"{lb} exec_s={secs:.3f} " + json.dumps(d)
                      for lb, secs, d in passes)
          + " | launches " + json.dumps(pay_launches), flush=True)

    # 3, fold_splice: the kernel on a real warm-pass probe (a third pass,
    #    untimed, records the call with the most spliced rows)
    with SpliceCapture() as cap:
        list(pay.evaluate())
    check(cap.best is not None, "the capture pass spliced nothing")
    rows["fold_splice"] = splice_vs_plain(cap)
    r = rows["fold_splice"]
    print(f"[3 kernels] fold_splice: {r['ms']:.4f} ms, device busy "
          f"{r['busy_ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by "
          f"{r['bound_by']}, {r['note']})", flush=True)

    # 9. streamed evaluation on fresh engines, against one-shot evaluation
    one = engine.evaluate(q, db2, capacity=C, cache=PAYLOAD_CACHE)
    check_rows(one.tuples, one.order, q, db2, want2, "one-shot (payload)")
    reset_launches()
    with SyncCounter() as sc:
        stream = engine.evaluate_stream(q, db2, capacity=C,
                                        cache=PAYLOAD_CACHE,
                                        emit_in_flight=STREAM_IN_FLIGHT)
        blocks = list(stream)
    stream_launches = read_launches()
    streamed = np.concatenate(blocks)
    check(np.array_equal(streamed, one.tuples),
          "the stream's blocks differ from one-shot evaluation")
    check(stream.result.counters["tier2_replay_hits"]
          == one.counters["tier2_replay_hits"],
          "stream and one-shot replay hits differ")
    check(sc.label_counts["emit-stream"] == len(blocks) > 0,
          "not every block went through the async emit queue")
    for name, n in stream_launches.items():
        if name in STATIC_ONLY + CHAIN_ONLY + LM_ONLY:
            continue
        if name != "fold_splice" or one.counters["fold_splice_calls_cuda"]:
            check(n > 0, f"kernel {name} was not launched by the stream")
    for name in pay_launches:
        pay_launches[name] += stream_launches[name]
    print(f"[9 stream] engine.evaluate_stream, emit_in_flight="
          f"{STREAM_IN_FLIGHT}, fresh engine: {len(blocks)} blocks, "
          f"{streamed.shape[0]} rows = one-shot in the same order; "
          f"exec_s={stream.result.exec_s:.3f} (one-shot "
          f"{one.exec_s:.3f}); async issues {sc.async_count} "
          f"({dict(sc.label_counts)['emit-stream']} emit-stream, "
          f"{sc.label_counts['replay-plan-async']} replay-plan-async), "
          f"blocking syncs {sc.count} | launches "
          + json.dumps(stream_launches)
          + f" | total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 10. the static executor (one fixed-capacity pass per call)
    static = static_phase(q, db, db2, want2, dev)
    static_launches = static["launches"]
    static_count = static["count"]
    se = static["engine"]
    static_ref = {k: static[k] for k in ("digests", "stats", "peak_gib")}

    # 3, fold_merged: the kernel on the static warm pass's merged fold (a
    #    third pass, untimed, records it)
    with MergedCapture() as mcap:
        se.evaluate_static(static["tables"])
    check(mcap.best is not None, "the capture pass merged nothing")
    rows["fold_merged"] = merged_vs_plain(mcap)
    r = rows["fold_merged"]
    print(f"[3 kernels] fold_merged: {r['ms']:.4f} ms, device busy "
          f"{r['busy_ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms by "
          f"{r['bound_by']}, {r['note']}) | total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    del mcap, static
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the distributed count and evaluation, DIST_WORLD processes
    dist_phase(q, db2, want2, static_count)
    print(f"[11 distributed] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 12. the chain EXPAND with the leapfrog membership kernel, and the
    #     public bounded search
    lf = leapfrog_phase(q, db, db2, want, want2, rows2, dev)
    print(f"[12 leapfrog] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 13. the serving layer
    served = serve_phase(q, db2, want2)
    srv = served["server"]
    print(f"[13 serve] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 15. the reference's knobs: the FOLD and EMIT op chains, and the
    #     paper's host engines
    knobs = knobs_phase(
        q, db2, want2, rows2,
        dict(digests=pay_digests,
             hits=[d["tier2_replay_hits"] for _, _, d in passes]),
        static_ref, dev)
    print(f"[15 knobs] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 14. LM serving: qwen2.5-3b at full width (the flash kernel was held
    #     against its plain version after phase 3)
    lm = lm_phase(dev)
    print(f"[14 lm] total {time.perf_counter() - t_start:.1f} s", flush=True)

    # 7. where the time goes (one more, traced pass of a path: the count
    #    and the chain count at ca-GrQc scale, an evaluation, a static
    #    evaluation, an LM prefill and 8 decode steps; the wiki-Vote
    #    count, the warm payload pass and the warm served query are not
    #    traced, for the script's time)
    def lm_serve():
        lm_model = lm["model"]
        lg, caches = lm_model.prefill({"tokens": lm["prompt"]})
        caches = pad_caches(lm_model.cfg, caches, 8)
        tok = lg.argmax(-1)[:, None]
        for i in range(8):
            lg, caches = lm_model.decode(caches, tok, LM_PROMPT + i)
            tok = lg.argmax(-1)[:, None]

    t7 = time.perf_counter()
    for label, run in (
            ("count-grqc", lambda: engine.count(q, db2, capacity=C)),
            ("evaluate", lambda: engine.evaluate(q, db2, capacity=C)),
            ("static-evaluate", lambda: se.evaluate_static()),
            ("chain-count-grqc",
             lambda: engine.count(q, db2, capacity=C, **CHAIN)),
            ("lm-prefill-decode8", lm_serve)):
        # the smallest trace holds the fast summary against the slow one
        print(f"[7 profile {label}] " + profile_line(
            run, cross_check=label == "static-evaluate"), flush=True)
    srv.close()
    print(f"[7 profile] phase {time.perf_counter() - t7:.1f} s", flush=True)

    # 16. training qwen2.5-3b at full width and depth, after phase 14's
    #     model, the static and payload engines and the server are freed
    lm.pop("model")
    served.pop("server")
    del se, pay, srv, lm_serve
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[16 train] device memory allocated before the phase "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    trained = train_phase(dev)
    print(f"[16 train] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 17. the other five block families at full width, one config at a
    #     time
    fam = family_phase(dev)
    print(f"[17 families] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 18. training over a (data, model) mesh in four processes on the card
    meshed = mesh_phase(dev)
    print(f"[18 mesh] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    # 19. the cost tools: the probe against a live count, the step's
    #     share of the peak, the join's dry-run on the card
    costed = cost_phase(trained)
    print(f"[19 cost] total {time.perf_counter() - t_start:.1f} s",
          flush=True)

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        n = ((launches[name] if name != "fold_splice" else 0)
             + pay_launches[name] + static_launches[name]
             + lf["launches"][name] + served["launches"][name]
             + knobs["launches"][name] + lm["launches"][name]
             + trained["launches"][name] + fam["launches"][name]
             + meshed["launches"].get(name, 0)
             + costed["launches"].get(name, 0))
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4]))
    if sys.argv[1:2] == ["--serve-worker"]:
        sys.exit(serve_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4]))
    sys.exit(main())
