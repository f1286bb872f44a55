"""Architecture configuration schema for the LM substrate.

A copy of the reference's ``repro/configs/base.py`` (it imports no JAX):
every architecture is an ``ArchConfig`` instance, one module per arch.
The fields are the reference's, all of them, so a reference config
carries across field for field (``convert.arch_config_from_reference``),
and the port's model honours every one (``cost_exact``: the loss in one
chunk, as the reference's cost probe takes it); :meth:`check_ported`
refuses a config that sets a field listed in ``WAITING`` (none now).
:meth:`param_count` and :meth:`active_param_count` count through the
port's ``models/specs.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple

# fields the port's model does not honour yet, with the ROADMAP item that
# ports them (Queue 1): a config that sets one away from its default is
# refused.  max_seq, which no model code reads, carries across as data.
WAITING: dict = {}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu (swiglu) | gelu
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- layer pattern (repeated; remainder layers appended unrolled) ---
    block_pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None   # sliding window for "local" blocks
    d_rnn: Optional[int] = None    # RG-LRU width
    conv_width: int = 4
    # --- vlm ---
    n_image_tokens: int = 0
    # --- enc-dec (audio) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # --- attention-free (rwkv) ---
    rwkv_head_dim: int = 64
    # --- training knobs ---
    remat_policy: str = "full"     # none | full | dots
    dtype_compute: str = "bfloat16"
    max_seq: int = 4096            # default trained context (shapes override)
    # cost-probe mode: the reference unrolls every scan (layers, flash
    # blocks, loss chunks) so XLA's cost analysis counts true totals; the
    # port's loops are Python, and its Model.loss takes one chunk, as the
    # reference's does (see launch/costprobe.py)
    cost_exact: bool = False
    # Megatron-style sequence parallelism: residuals/LN constrained to a
    # sequence-sharded layout between blocks, turning per-layer activation
    # all-reduces into reduce-scatter+all-gather pairs (half the bytes) and
    # shrinking saved activations by the model-axis factor.  Only meaningful
    # under a mesh; the port trains on one device, where the reference's
    # constraint is a no-op too (its transformer.py::_seq_shard_constraint
    # outside a mesh), so the port reads the flag and changes nothing.
    seq_shard: bool = False

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_rem_layers(self) -> int:
        return self.n_layers % len(self.pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.pattern
        return p * self.n_groups + p[: self.n_rem_layers]

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` naming the first field this config
        sets that the port's model does not honour (``WAITING``)."""
        for f in fields(self):
            value = getattr(self, f.name)
            if f.name in WAITING and value != f.default:
                raise NotImplementedError(
                    f"{self.name}: {f.name}={value!r} is not ported yet "
                    f"(ROADMAP Queue 1, {WAITING[f.name]})")

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of this config, from its specs (no
        allocation).  MoE counts all experts; :meth:`active_param_count`
        counts the routed-active ones."""
        from ..models.specs import model_specs, count_params
        return count_params(model_specs(self))

    def active_param_count(self) -> int:
        """Parameters a token runs through: every expert of each ``"moe"``
        layer replaced by ``top_k`` of them (the reference's count)."""
        total = self.param_count()
        if self.n_experts and self.top_k:
            from ..models.specs import expert_params
            all_e, per_e = expert_params(self)
            total = total - all_e + self.top_k * per_e * len(
                [k for k in self.layer_kinds() if k == "moe"])
        return total

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        pat_len = len(self.pattern)
        n_layers = max(pat_len, min(2 * pat_len, 4))
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab=256,
            d_rnn=64 if self.d_rnn else None,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=16 if self.window else None,
            n_image_tokens=8 if self.n_image_tokens else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=16 if self.encoder_seq else 0,
            rwkv_head_dim=16,
            max_seq=32,
        )
