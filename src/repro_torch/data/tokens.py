"""Deterministic, shardable, checkpointable LM token pipeline.

The synthetic stream is *learnable*: token_{i+1} = (a·token_i + c) mod V
with probability 1-ε, uniform noise otherwise — so a trained model's loss
drops visibly below ln(V) toward the noise entropy (used by the train_lm
example).  Batches are a pure function of (seed, step), so resuming from a
checkpointed step reproduces the exact stream (no iterator state files), and
each data shard draws a disjoint sub-stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    a: int = 7
    c: int = 3


def batch_at(cfg: DataConfig, step: int,
             shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
    """The (sharded) batch for a given step; pure function of its args."""
    assert cfg.global_batch % num_shards == 0
    local = cfg.global_batch // num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    B, T, V = local, cfg.seq_len, cfg.vocab
    toks = np.empty((B, T + 1), np.int32)
    toks[:, 0] = rng.integers(0, V, size=B)
    noise = rng.random((B, T)) < cfg.noise
    rand = rng.integers(0, V, size=(B, T))
    for t in range(T):
        nxt = (cfg.a * toks[:, t] + cfg.c) % V
        toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    return {"tokens": toks[:, :-1],
            "targets": toks[:, 1:].astype(np.int32)}


def iterate(cfg: DataConfig, start_step: int = 0,
            shard: int = 0, num_shards: int = 1,
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, shard, num_shards)
        step += 1
