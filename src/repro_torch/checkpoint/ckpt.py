"""Checkpointing: atomic, retention-managed, async-capable.

The counterpart of the reference's ``repro/checkpoint/ckpt.py``.  A state
is a nested dict of tensors (or numpy arrays); its leaves are copied to
host numpy in the caller and written as an ``.npz`` (keys: the nested
names joined by ``||``, as in the reference) plus a JSON manifest under
``.tmp-<step>``, then renamed to ``step_<10 digits>`` — a crash mid-write
never corrupts the latest checkpoint.  A background thread makes saves
non-blocking; ``wait()`` joins it (called before the next save, before a
restore and at the end of a run).  ``keep`` bounds the checkpoints kept.
Saved values are whole (unsharded) tensors, so a checkpoint restores onto
any device or mesh (``runtime/elastic.py``).  A state placed on a mesh
(DTensor leaves) is gathered whole on every rank (``full_tensor()``, a
collective: every rank calls ``save``); rank 0 alone copies each to the
host, the gathered tensor dropped as soon as it is copied, and writes
them.  A restore given ``shardings`` places each leaf on their mesh,
every rank keeping its own shard.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_SEP = "||"


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        for name, sub in tree.items():
            yield from _leaves(sub, prefix + (str(name),))
    else:
        yield _SEP.join(prefix), tree


def _to_host(leaf, keep: bool = True) -> Optional[np.ndarray]:
    """A host copy of a leaf (never a view of a tensor that later steps
    write in place); a DTensor is gathered whole first (a collective:
    every rank gathers), and only a rank that ``keep``s it copies it to
    the host (None otherwise)."""
    if hasattr(leaf, "device_mesh"):
        leaf = leaf.full_tensor()
    if not keep:
        return None
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _rebuild(like, data, shardings=None, prefix: Tuple[str, ...] = ()):
    if isinstance(like, dict):
        return {name: _rebuild(sub, data,
                               None if shardings is None else shardings[name],
                               prefix + (str(name),))
                for name, sub in like.items()}
    key = _SEP.join(prefix)
    arr = data[key]
    shape = tuple(like.shape if hasattr(like, "shape") else like)
    if tuple(arr.shape) != shape:
        raise ValueError(f"{key}: checkpoint has shape {arr.shape}, "
                         f"expected {shape}")
    if shardings is None:
        return torch.from_numpy(arr)
    from ..sharding.rules import place
    return place(torch.from_numpy(arr), shardings)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[Dict] = None) -> None:
        """Write ``state`` as step ``step``; its leaves are copied to the
        host before this returns, the file is written on a thread when
        ``async_save``.  Over a mesh every rank calls this and only rank
        0 writes."""
        self.wait()
        writer = _rank() == 0
        arrays = {k: _to_host(v, writer) for k, v in _leaves(state)}
        if not writer:
            return
        meta = {"step": int(step), "extra": extra or {}}

        def write():
            tmp = os.path.join(self.dir, f".tmp-{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.async_save:
            def run():
                try:
                    write()
                except BaseException as e:   # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None, shardings=None,
                ) -> Tuple[int, Any, Dict]:
        """(step, state, extra): the checkpoint at ``step`` (the latest by
        default) in the structure of ``like`` (a nested dict whose leaves
        are tensors, arrays or shapes, which the saved arrays must
        match), as CPU tensors of the saved dtypes; or, given
        ``shardings`` (a ``rules.NamedSharding`` a leaf, keyed as
        ``like``), as DTensors placed on their mesh (the reference's
        ``shardings``)."""
        self.wait()
        if shardings is not None:
            import torch.distributed as dist
            dist.barrier()      # rank 0's write is on disk for every rank
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            state = _rebuild(like, data, shardings)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return meta["step"], state, meta["extra"]
