"""Training launcher: --arch <id> [--smoke] with the fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 50 --batch 8 --seq 64 --device cpu

The counterpart of the reference's ``repro/launch/train.py`` on one
device: it runs on the card (``--device cuda``, the default, raises
without CUDA) unless ``--device cpu`` is given.  The reference's mesh
(``--model-parallel``) waits for training on several cards: any value
but 1 raises.
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
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: training on several "
            "cards is not ported yet (ROADMAP Queue 1, item 4e)")

    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_arch(name)
    model = Model(cfg, device=args.device)
    print(f"[train] {cfg.name}: {model.param_count() / 1e6:.1f}M params on "
          f"{model.device}")
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    hist = train(
        model, data,
        TrainConfig(microbatches=args.microbatches,
                    opt=OptConfig(lr=args.lr, warmup_steps=10,
                                  decay_steps=args.steps)),
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   log_every=10, ckpt_dir=args.ckpt_dir))
    if hist["loss"]:
        print(f"[train] done: loss {hist['loss'][0]:.3f} -> "
              f"{hist['loss'][-1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
