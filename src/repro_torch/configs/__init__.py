"""Configurations.

``paper_clftj`` holds the join engine's :class:`~.paper_clftj.JoinEngineConfig`
and its presets.  The rest is the LM substrate's architecture registry
(``--arch <id>`` resolves here), copied from the reference's
``repro/configs``: the four dense architectures, whose blocks the port
runs.  The reference's other six families need blocks the port does not
have yet; naming one raises ``NotImplementedError``.
"""
from typing import Dict

from .base import ArchConfig
from .minitron_8b import CONFIG as minitron_8b
from .stablelm_12b import CONFIG as stablelm_12b
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .yi_6b import CONFIG as yi_6b

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in [minitron_8b, stablelm_12b, qwen2_5_3b, yi_6b]
}

# the reference's other architectures, with the blocks they wait for
NOT_PORTED: Dict[str, str] = {
    "recurrentgemma-2b": "RG-LRU and local-attention blocks",
    "qwen3-moe-235b-a22b": "MoE block",
    "phi3.5-moe-42b-a6.6b": "MoE block",
    "llama-3.2-vision-90b": "VLM cross-attention block",
    "rwkv6-7b": "RWKV-6 block",
    "whisper-tiny": "audio encoder-decoder blocks",
}


def get_arch(name: str) -> ArchConfig:
    """The named config; ``<name>-smoke`` gives its reduced CPU-size twin."""
    base = name[: -len("-smoke")] if name.endswith("-smoke") else name
    if base in NOT_PORTED:
        raise NotImplementedError(
            f"{base}: its {NOT_PORTED[base]} are not ported yet "
            "(ROADMAP Queue 1, item 4c)")
    cfg = ARCHS[base]
    return cfg.smoke() if base != name else cfg
