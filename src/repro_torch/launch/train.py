"""Training launcher: --arch <id> [--smoke] with the fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 50 --batch 8 --seq 64 --device cpu

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2.5-3b --model-parallel 2

The counterpart of the reference's ``repro/launch/train.py``.  It runs on
the card (``--device cuda``, the default, raises without CUDA) unless
``--device cpu`` is given.  Started by ``torchrun`` (``WORLD_SIZE`` in
the environment) it joins the process group (NCCL on cards, one a rank;
gloo with ``--device cpu``) and trains over a (world / N, N) ``("data",
"model")`` mesh, ``--model-parallel N``; alone, with N 1, on one device.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

from ..configs import get_arch
from ..data.tokens import DataConfig
from ..models import Model
from ..optim.adamw import OptConfig
from ..train.loop import LoopConfig, train
from ..train.train_step import TrainConfig
from .mesh import make_local_mesh


def _join_group(device: str):
    """The process group ``torchrun`` describes, or None when this is the
    only process."""
    import torch
    import torch.distributed as dist
    from ..core.frontier import resolve_device
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return None
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return dist


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_arch(name)
    dist = _join_group(args.device)
    if dist is None and args.model_parallel != 1:
        raise ValueError(f"--model-parallel {args.model_parallel} needs "
                         "several processes (start under torchrun)")
    model = Model(cfg, device=args.device)
    mesh = None if dist is None else make_local_mesh(
        args.model_parallel, device_type=model.device.type)
    rank0 = dist is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    say(f"[train] {cfg.name}: {model.param_count() / 1e6:.1f}M params on "
        f"{model.device}" + ("" if mesh is None else f", mesh {mesh}"))
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    try:
        hist = train(
            model, data,
            TrainConfig(microbatches=args.microbatches,
                        opt=OptConfig(lr=args.lr, warmup_steps=10,
                                      decay_steps=args.steps)),
            LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       log_every=10, ckpt_dir=args.ckpt_dir),
            mesh=mesh, log=say)
    finally:
        if dist is not None:
            dist.destroy_process_group()
    if hist["loss"]:
        say(f"[train] done: loss {hist['loss'][0]:.3f} -> "
            f"{hist['loss'][-1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
