"""Architecture registry: ``--arch <id>`` resolution.

Counterpart of ``repro.configs.registry`` for the families the port runs:
the dense and MoE transformers. An architecture of another family (hybrid,
ssm, vlm, audio) raises ``NotImplementedError`` naming the ROADMAP item
that ports it; nothing stands in for it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (arctic_480b, gemma_2b, granite_3_2b,
                                 granite_moe_1b_a400m, internlm2_20b, yi_9b)
from repro_torch.configs.base import ModelConfig, smoke_variant

_MODULES = (yi_9b, gemma_2b, internlm2_20b, granite_3_2b, granite_moe_1b_a400m,
            arctic_480b)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCH_IDS = tuple(REGISTRY)

# the reference's other architectures, by family, and where the port
# stands on each (ROADMAP A14)
NOT_PORTED = {
    "zamba2-2.7b": "hybrid", "xlstm-350m": "ssm",
    "qwen2-vl-72b": "vlm", "whisper-base": "audio",
}
_FAMILY_MODULES = {"hybrid": "models/zamba.py and models/mamba2.py",
                   "ssm": "models/xlstm.py", "vlm": "M-RoPE in models/layers.py",
                   "audio": "models/encdec.py"}


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return smoke_variant(get_config(arch[: -len("-smoke")]))
    if arch in NOT_PORTED:
        family = NOT_PORTED[arch]
        raise NotImplementedError(
            f"{arch} is a {family} architecture; the port runs the dense "
            f"and moe families only so far ({family}: {_FAMILY_MODULES[family]}, ROADMAP A14)")
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]
