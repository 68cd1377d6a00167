"""Architecture config registry: ``--arch <id>`` resolution.

The Mamba-2 (mamba2-130m), Mamba-1 (mamba-130m), RecurrentGemma
(recurrentgemma-2b) and dense transformer (gemma-2b, qwen1.5-4b) paths
are ported; every other architecture of the JAX package's registry
raises ``NotImplementedError`` here.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.base import ModelConfig

_ARCHS: Dict[str, str] = {
    "mamba2-130m": "mamba2_130m",
    "mamba-130m": "mamba_130m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "gemma-2b": "gemma_2b",
    "qwen1.5-4b": "qwen15_4b",
}


def get_config(arch: str, *, reduced: bool = False, **overrides
               ) -> ModelConfig:
    if arch not in _ARCHS:
        raise NotImplementedError(f"arch {arch!r} is not ported; ported: "
                                  f"{sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    cfg = mod.REDUCED if reduced else mod.CONFIG
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
