"""CUDA tier-2 table ops: the wrappers around ``csrc/tier2.cu``.

Replace no Pallas kernel: the reference's probe and insert are XLA op
chains (``repro/core/cache.py``), as the plain twins here are PyTorch
ones (``plain.py``).  The kernels' work follows the live rows of the
chunk: one thread a row, which leaves at once on an inactive row, and no
``(C, W)`` gather of the table.

* :func:`probe` and :func:`probe_payload` (``ctj_tier2_probe``): one
  kernel launch; the stamp plane is copied first and touched in the copy.
  ``probe_launches`` counts the kernel's launches.
* :func:`insert` (``ctj_tier2_insert``): the tables are copied first and
  written in the copies, two kernel launches a round (elect, write) after
  two memsets.  ``insert_launches`` counts the kernel launches, two a
  round.

The wrappers check device, dtype, shape and contiguity of every tensor
they pass, allocate outputs and scratch with ``torch.empty`` and launch on
PyTorch's current stream; the admit and evict counts stay on the device.
None has a plain fallback: a failed launch raises.  Their results equal
the plain twins' bit for bit.
"""
from __future__ import annotations

import torch

from .. import cudalib

__all__ = ["probe", "probe_payload", "insert",
           "probe_launches", "insert_launches"]

_POLICY_CODES = {"direct": 0, "setassoc": 1, "costaware": 2}

probe_launches = 0
insert_launches = 0

_I64, _I32, _BOOL = torch.int64, torch.int32, torch.bool


def _table_ptrs(planes, dtypes, dev, S, W):
    return [None if t is None else cudalib.ptr(t, f"table {name}", dev, dt,
                                                (S, W))
            for (name, t), dt in zip(planes.items(), dtypes)]


def _row_ptrs(rows, dtypes, dev, C):
    return [None if t is None else cudalib.ptr(t, name, dev, dt, (C,))
            for (name, t), dt in zip(rows.items(), dtypes)]


def _probe(tkeys, tvals, tused, tstamp, tpoff, tplen, keys, active, tick):
    global probe_launches
    dev = keys.device
    S, W = tkeys.shape
    C = keys.shape[0]
    tk, tv, tu, tpo, tpl = _table_ptrs(
        {"keys": tkeys, "vals": tvals, "used": tused, "pay_off": tpoff,
         "pay_len": tplen}, (_I64, _I64, _BOOL, _I32, _I32), dev, S, W)
    cudalib.ptr(tstamp, "table stamp", dev, _I32, (S, W))
    k, a = _row_ptrs({"keys": keys, "active": active}, (_I64, _BOOL), dev, C)
    stamp = tstamp.clone()
    hit = torch.empty(C, dtype=_BOOL, device=dev)
    if tplen is None:
        vals = torch.empty(C, dtype=_I64, device=dev)
        outs = (vals.data_ptr(), None, None)
    else:
        poff = torch.empty(C, dtype=_I32, device=dev)
        plen = torch.empty(C, dtype=_I32, device=dev)
        outs = (None, poff.data_ptr(), plen.data_ptr())
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_tier2_probe(tk, tv, tu, stamp.data_ptr(), tpo, tpl, k,
                                  a, C, S, W, tick, hit.data_ptr(), *outs,
                                  cudalib.stream_ptr(keys))
    cudalib.check(err, "ctj_tier2_probe")
    probe_launches += 1 if C else 0
    if tplen is None:
        return hit, vals, stamp
    return hit, poff, plen, stamp


def probe(tkeys, tvals, tused, tstamp, keys, active, tick: int):
    """Batched lookup on the card: ``(hit, vals, stamp')`` as
    ``plain.probe``."""
    return _probe(tkeys, tvals, tused, tstamp, None, None, keys, active,
                  tick)


def probe_payload(tkeys, tused, tstamp, tpoff, tplen, keys, active,
                  tick: int):
    """Evaluation-mode lookup on the card: ``(hit, poff, plen, stamp')``
    as ``plain.probe_payload``."""
    return _probe(tkeys, None, tused, tstamp, tpoff, tplen, keys, active,
                  tick)


def insert(tkeys, tvals, tused, tstamp, tcost, keys, vals, costs, active,
           tick: int, *, policy: str, rounds: int = 1, pay=None):
    """Batched fill on the card: the new tables, then with ``pay`` the new
    ``(tpoff, tplen)``, then the admit and evict counts (0-d int32), as
    ``plain.insert``."""
    global insert_launches
    if policy not in _POLICY_CODES:
        raise ValueError(f"unknown cache policy {policy!r}")
    dev = keys.device
    S, W = tkeys.shape
    C = keys.shape[0]
    tpoff = tplen = poff = plen = None
    if pay is not None:
        tpoff, tplen, poff, plen = pay
    _table_ptrs({"keys": tkeys, "vals": tvals, "used": tused,
                 "stamp": tstamp, "cost": tcost, "pay_off": tpoff,
                 "pay_len": tplen}, (_I64, _I64, _BOOL, _I32, _I64, _I32,
                                     _I32), dev, S, W)
    k, v, c, _, po, pl = _row_ptrs(
        {"keys": keys, "vals": vals, "costs": costs, "active": active,
         "poff": poff, "plen": plen},
        (_I64, _I64, _I64, _BOOL, _I32, _I32), dev, C)
    tables = [None if t is None else t.clone()
              for t in (tkeys, tvals, tused, tstamp, tcost, tpoff, tplen)]
    remaining = active.clone()
    choice = torch.empty(C, dtype=_I32, device=dev)
    winner = torch.empty(S, dtype=_I64, device=dev)
    counts = torch.empty(2, dtype=_I32, device=dev)
    lib = cudalib.load()
    with torch.cuda.device(dev):
        err = lib.ctj_tier2_insert(
            *[None if t is None else t.data_ptr() for t in tables], k, v, c,
            po, pl, C, S, W, tick, _POLICY_CODES[policy], rounds,
            remaining.data_ptr(), choice.data_ptr(), winner.data_ptr(),
            counts.data_ptr(), cudalib.stream_ptr(keys))
    cudalib.check(err, "ctj_tier2_insert")
    insert_launches += 2 * max(1, rounds) if C else 0
    out = tuple(t for t in tables if t is not None)
    return out + (counts[0], counts[1])
