"""The input-shape grid and abstract inputs of the dry-run.

The counterpart of the reference's ``repro/launch/shapes.py``: every
(arch × shape) cell resolves to shape-and-dtype stand-ins
(``models.specs.TensorSpec``), nothing allocated.  ``decode_*`` and
``long_*`` run one decode step (one token against a cache of ``seq``
positions); ``long_500k`` needs sub-quadratic attention and is skipped
for the full-attention archs (recorded as skipped).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..models.specs import TensorSpec


@dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic sequence handling (hybrid local-attn / SSM)
SUBQUADRATIC = ("recurrentgemma-2b", "rwkv6-7b")


def cell_supported(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, ("full O(L^2) attention at 524288 would be a " +
                       "degenerate lowering; skipped per assignment")
    return True, ""


def batch_specs(cfg: ArchConfig, case: ShapeCase) -> Dict[str, TensorSpec]:
    """Token and modality inputs of the cell: int32 tokens (and targets),
    bf16 image or audio embeds."""
    B, T = case.batch, case.seq
    if case.kind == "decode":
        toks = TensorSpec((B, 1), torch.int32)
    else:
        toks = TensorSpec((B, T), torch.int32)
    batch = {"tokens": toks}
    if case.kind == "train":
        batch["targets"] = TensorSpec((B, T), torch.int32)
    if cfg.family == "vlm" and case.kind != "decode":
        batch["image_embeds"] = TensorSpec(
            (B, cfg.n_image_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio" and case.kind != "decode":
        batch["audio_embeds"] = TensorSpec(
            (B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return batch
