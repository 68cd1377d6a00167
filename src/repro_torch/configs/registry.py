"""Architecture config registry: ``--arch <id>`` resolution.

Every architecture of the JAX package's registry is ported: Mamba-2
(mamba2-130m, mamba2-2.7b), Mamba-1 (mamba-130m), RecurrentGemma
(recurrentgemma-2b), the dense transformer (gemma-2b, qwen1.5-4b,
deepseek-7b, internlm2-20b), its MoE variants (qwen3-moe-30b-a3b,
grok-1-314b), its vision stub (llava-next-mistral-7b) and the
encoder-decoder whisper-tiny.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.base import ModelConfig

_ARCHS: Dict[str, str] = {
    "internlm2-20b": "internlm2_20b",
    "deepseek-7b": "deepseek_7b",
    "qwen1.5-4b": "qwen15_4b",
    "gemma-2b": "gemma_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "grok-1-314b": "grok1_314b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    # the paper's own evaluation subjects
    "mamba-130m": "mamba_130m",
    "mamba2-130m": "mamba2_130m",
}

# The JAX package's assigned archs: every arch but the paper's two 130m
# evaluation subjects.
ASSIGNED = [a for a in _ARCHS if not a.endswith("130m")]


def list_archs() -> List[str]:
    return list(_ARCHS)


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
