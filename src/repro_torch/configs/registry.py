"""Architecture registry: ``--arch <id>`` resolution.

Counterpart of ``repro.configs.registry``: all ten architectures, their
``-smoke`` variants (:func:`smoke_variant`) and their ``-fast`` variants
(the chunked-parallel mLSTM for xLSTM; every other architecture
unchanged).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (arctic_480b, gemma_2b, granite_3_2b,
                                 granite_moe_1b_a400m, internlm2_20b,
                                 qwen2_vl_72b, whisper_base, xlstm_350m, yi_9b,
                                 zamba2_2_7b)
from repro_torch.configs.base import ModelConfig, smoke_variant

_MODULES = (yi_9b, gemma_2b, internlm2_20b, granite_3_2b, granite_moe_1b_a400m,
            arctic_480b, zamba2_2_7b, xlstm_350m, qwen2_vl_72b, whisper_base)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch.endswith("-smoke"):
        return smoke_variant(get_config(arch[: -len("-smoke")]))
    if arch.endswith("-fast"):
        cfg = get_config(arch[: -len("-fast")])
        if cfg.xlstm is not None:
            return dataclasses.replace(
                cfg, xlstm=dataclasses.replace(cfg.xlstm, parallel_mlstm=True))
        return cfg
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]
