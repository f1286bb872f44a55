"""Training loop with checkpoint/restart, preemption handling and a
straggler watch.

The counterpart of the reference's ``repro/train/loop.py``, on one device
or over a mesh (``mesh``: the step is built with it and the state placed
on it).  The step runs eagerly (the reference jits it).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint.ckpt import CheckpointManager
from ..data import tokens as dtok
from ..runtime.elastic import restore_for_mesh
from ..runtime.fault import PreemptionGuard, StragglerWatch
from .train_step import (TrainConfig, init_train_state, make_train_step,
                         place_train_state)


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    seed: int = 0


def train(model, data_cfg: dtok.DataConfig, tcfg: TrainConfig,
          lcfg: LoopConfig, mesh=None, log: Callable[[str], None] = print,
          fail_at_step: Optional[int] = None) -> Dict[str, List[float]]:
    """Run (or resume) training of ``model`` on its device, or over
    ``mesh`` (every rank runs this; each takes its shard of every
    global batch).  ``fail_at_step`` injects a crash (tests).

    Returns the metric history.  Restart-safe: rerunning with the same
    ckpt_dir resumes from the latest checkpoint and reproduces the same
    data stream (the pipeline is a pure function of step).  A fresh start
    draws the parameters from a ``torch.Generator`` seeded ``lcfg.seed``
    on the model's device (``Model.reset_parameters``).  A resume
    restores without a mesh, as the reference's, and then places the
    state on ``mesh``.
    """
    ckpt = CheckpointManager(lcfg.ckpt_dir, keep=lcfg.keep)
    step_fn = make_train_step(model, tcfg, mesh)
    guard = PreemptionGuard().install()
    watch = StragglerWatch(on_flag=lambda s, m: log(
        f"[straggler] step took {s:.2f}s vs median {m:.2f}s"))

    start_step = 0
    if ckpt.latest_step() is not None:
        start_step, state, _ = restore_for_mesh(ckpt, model)
        if mesh is not None:
            state = place_train_state(model, state, mesh)
        log(f"[resume] restored checkpoint at step {start_step}")
    else:
        model.reset_parameters(
            torch.Generator(device=model.device).manual_seed(lcfg.seed))
        state = init_train_state(model, mesh)

    history: Dict[str, List[float]] = {"loss": [], "step_time": []}
    try:
        for step in range(start_step, lcfg.total_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in dtok.batch_at(data_cfg, step).items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            watch.observe(dt)
            history["loss"].append(loss)
            history["step_time"].append(dt)
            if (step + 1) % lcfg.log_every == 0:
                log(f"step {step + 1:5d}  loss {loss:.4f}  {dt * 1e3:.0f} ms")
            stop = guard.should_stop
            if (step + 1) % lcfg.ckpt_every == 0 or stop or \
                    step + 1 == lcfg.total_steps:
                ckpt.save(step + 1, state)
            if stop:
                log("[preempt] stop requested; checkpoint written, exiting")
                break
    finally:
        ckpt.wait()     # a crash too waits for the pending write
        guard.uninstall()
    return history
