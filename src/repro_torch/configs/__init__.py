"""Configurations.

``paper_clftj`` holds the join engine's :class:`~.paper_clftj.JoinEngineConfig`
and its presets.  The rest is the LM substrate's architecture registry
(``--arch <id>`` resolves here), copied from the reference's
``repro/configs``: all ten of its architectures, each with a ``-smoke``
twin.
"""
from typing import Dict

from .base import ArchConfig
from .minitron_8b import CONFIG as minitron_8b
from .stablelm_12b import CONFIG as stablelm_12b
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .yi_6b import CONFIG as yi_6b
from .recurrentgemma_2b import CONFIG as recurrentgemma_2b
from .qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from .phi3_5_moe_42b_a6_6b import CONFIG as phi3_5_moe_42b_a6_6b
from .llama_3_2_vision_90b import CONFIG as llama_3_2_vision_90b
from .rwkv6_7b import CONFIG as rwkv6_7b
from .whisper_tiny import CONFIG as whisper_tiny

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in [
        minitron_8b, stablelm_12b, qwen2_5_3b, yi_6b, recurrentgemma_2b,
        qwen3_moe_235b_a22b, phi3_5_moe_42b_a6_6b, llama_3_2_vision_90b,
        rwkv6_7b, whisper_tiny,
    ]
}


def get_arch(name: str) -> ArchConfig:
    """The named config; ``<name>-smoke`` gives its reduced CPU-size twin."""
    if name.endswith("-smoke"):
        return ARCHS[name[: -len("-smoke")]].smoke()
    return ARCHS[name]
