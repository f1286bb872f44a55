"""Roofline terms of one rank's step on the H100, with no card.

The counterpart of the reference's ``repro/launch/roofline.py``: the same
three terms, the same ``Roofline`` fields and ``as_dict`` keys,
``model_flops`` and ``weighted_collective_bytes`` (a ring all-reduce
weighted 2x for its two passes).  The counts come from
``launch/costprobe.py`` (the step run once on a fake process group,
every op on one rank's local tensors), where the reference's come from
XLA's cost analysis and HLO text.

Hardware: one H100 SXM at its 700 W power limit, the published peaks
(NVIDIA's H100 datasheet, dense):

* compute term    = FLOPs / peak of the cell's compute dtype: 989e12
                    FLOP/s in bf16 and fp16 on the tensor cores, 67e12
                    in fp32 outside them;
* memory term     = bytes / 3.35e12 B/s of HBM3;
* collective term = Σ collective bytes / 450e9 B/s, NVLink's rate each
                    way between two cards of one host (18 links of 25
                    GB/s).  An axis that spans more than one host's 8
                    cards crosses the hosts' network, which is slower;
                    this one constant does not model that, as the
                    reference's one ICI constant does not model its
                    multi-pod links.

None of the reference's TPU v5e constants carry over.  MODEL_FLOPS =
6·N·D (train) / 2·N·D (inference), N = routed-active params: the ratio
MODEL_FLOPS / counted FLOPs exposes remat and padding waste.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card each way (NVLink)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def weighted_collective_bytes(per_op: Dict[str, int]) -> float:
    w = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}
    return sum(per_op[k] * w[k] for k in per_op)


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    per_op: Dict[str, int]
    n_devices: int
    model_flops_per_device: float = 0.0
    dtype: str = "bfloat16"        # the cell's compute dtype: its peak

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        return (self.model_flops_per_device / self.flops) if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at its
        dominant-term speed: (useful FLOPs / peak) / bound time."""
        if self.bound_s == 0:
            return 0.0
        return (self.model_flops_per_device / self.peak_flops) / self.bound_s

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.coll_bytes,
            "collectives": self.per_op,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, case, n_devices: int) -> float:
    """6·N·tokens (train) or 2·N·tokens (inference), per device."""
    n_active = cfg.active_param_count()
    if case.kind == "train":
        tokens = case.batch * case.seq
        total = 6.0 * n_active * tokens
    elif case.kind == "prefill":
        tokens = case.batch * case.seq
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * case.batch
    return total / n_devices


def from_costs(costs: Dict, cfg, case, n_devices: int) -> Roofline:
    """The roofline of a probe's per-rank totals (``costprobe``: flops,
    bytes, collectives by kind) for ``cfg``'s cell ``case``."""
    per_op = {k: int(v) for k, v in costs["collectives"].items()}
    return Roofline(flops=costs["flops"], bytes_accessed=costs["bytes"],
                    coll_bytes=weighted_collective_bytes(per_op),
                    per_op=per_op, n_devices=n_devices,
                    model_flops_per_device=model_flops(cfg, case, n_devices),
                    dtype=cfg.dtype_compute)
